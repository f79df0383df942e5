"""The live telemetry plane: sampler ring, ``/statusz``, ``/metrics``.

Copy of ``dsi_tpu/obs/live.py``.

The tracer is post-hoc — you learn where the wall went after the
run flushes.  This module is the *in-flight* half the ROADMAP's
serving-daemon and speculative-execution items need (the paper ships a
live status page as a first-class framework feature, Dean & Ghemawat
§4.8): a running engine answers "what step are you on, what do your
stage latencies look like, is anything stalled" over HTTP while it
runs, and a bounded ``live.jsonl`` ring survives a crash for post-hoc
"what was it doing right before".

Default OFF = zero threads, zero overhead: nothing here is imported
until a CLI passes ``--statusz-port`` (or sets ``DSI_STATUSZ_PORT``),
and the span path's only cost stays the one module-attribute check in
``obs/trace.py``.  When ON:

* :class:`LiveTelemetry` binds a localhost-only HTTP server
  (``127.0.0.1`` — this is an operator peephole, not a public
  surface; port 0 picks a free port, printed to stderr) serving

  - ``/statusz`` — plain text: per-pipeline in-flight window (current
    step ordinal, oldest in-flight age), per-engine counters, the
    stage latency percentile table, heartbeat ages, stalls;
  - ``/metrics`` — Prometheus text format: the same data as
    ``dsi_*`` gauges/summaries, scrape-ready;
  - ``/healthz`` — ``{"ok": true}``.

  Both endpoints build their answer ON DEMAND from the metrics
  registry, the stage histograms, and the live-pipeline registry
  (``obs/hist.py``) — always current, no staleness window.

* a sampler thread snapshots the same state every
  ``DSI_STATUSZ_INTERVAL_S`` (default 1 s) into a bounded ring
  (``DSI_LIVE_RING`` samples, default 256) and — when a directory is
  known (the run's ``--trace-dir``) — rewrites ``live.jsonl`` with the
  ring's contents via temp+rename, so the file is bounded and never
  torn mid-line.  The first sample is taken at start, so even a run
  that crashes in device init leaves one.

Starting the plane activates the stage histograms with a *hold*
(``hist.hold``): a bench toggling its in-memory tracer off cannot drop
the sampler's percentiles mid-serve.
"""

from __future__ import annotations

import collections
import json
import os
import re
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from dsi_tpu_torch.obs import hist as _hist
from dsi_tpu_torch.obs.registry import get_registry
from dsi_tpu_torch.obs.trace import get_tracer


_env_float = _hist.env_float


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


_METRIC_SANE = re.compile(r"[^a-zA-Z0-9_]")


def _mname(s: str) -> str:
    return _METRIC_SANE.sub("_", str(s))


# ── pluggable sections (the serving daemon's tenant table) ─────────────
#
# A resident process with state of its own (``dsi_tpu/serve``'s
# per-tenant table) registers a section here: ``statusz_fn`` returns the
# section's plain-text body (one indented line per row), ``metrics_fn``
# (optional) returns ready Prometheus lines.  Both are called on demand
# under the same no-staleness rule as the built-in sections; a provider
# that raises is skipped, never kills the scrape.

_sections_lock = threading.Lock()
_sections: Dict[str, tuple] = {}


def register_section(name: str, statusz_fn, metrics_fn=None) -> None:
    """Add (or replace) a named /statusz section + optional /metrics
    lines provider."""
    with _sections_lock:
        _sections[name] = (statusz_fn, metrics_fn)


def unregister_section(name: str) -> None:
    with _sections_lock:
        _sections.pop(name, None)


def _section_items() -> list:
    with _sections_lock:
        return sorted(_sections.items())


class LiveTelemetry:
    """One live telemetry server + sampler (module docstring)."""

    def __init__(self, port: int = 0, live_dir: Optional[str] = None,
                 interval_s: Optional[float] = None,
                 ring: Optional[int] = None):
        self.port = int(port)
        self.live_dir = live_dir
        self.interval_s = (interval_s if interval_s is not None
                           else _env_float("DSI_STATUSZ_INTERVAL_S", 1.0))
        self.ring: "collections.deque" = collections.deque(
            maxlen=max(1, ring if ring is not None
                       else _env_int("DSI_LIVE_RING", 256)))
        self.samples = 0
        self._t0 = time.time()
        self._stop = threading.Event()
        self._srv: Optional[ThreadingHTTPServer] = None
        self._threads: list = []

    # ── state assembly (shared by /statusz, /metrics, the ring) ──

    def snapshot(self) -> Dict:
        """One JSON-ready sample of everything live: registry scopes +
        gauges + histograms, per-pipeline in-flight state, tracer
        counters.  Built on demand — this IS the statusz answer."""
        tr = get_tracer()
        pipes = []
        for p in _hist.live_pipelines():
            try:
                pipes.append(p.live_state())
            except Exception:  # a pipeline mid-teardown: skip, not die
                pass
        snap = {"ts": round(time.time(), 3),
                "uptime_s": round(time.time() - self._t0, 3),
                "pid": os.getpid(),
                "pipelines": pipes,
                "counters": tr.counters_snapshot(),
                "dropped_events": tr.dropped}
        snap.update(get_registry().snapshot())
        return snap

    # ── renderers ──

    def statusz_text(self) -> str:
        s = self.snapshot()
        out = [f"dsi statusz  pid={s['pid']} "
               f"uptime={s['uptime_s']:.1f}s "
               f"interval={self.interval_s}s samples={self.samples}"]
        out.append("-- pipelines (in flight) --")
        if not s["pipelines"]:
            out.append("  (none running)")
        for p in s["pipelines"]:
            out.append(
                f"  {p['engine'] or '?'}: dispatched={p['dispatched']} "
                f"finished={p['finished']} inflight={p['inflight']} "
                f"depth={p['depth']} step={p['step']} "
                f"oldest_age_s={p['oldest_age_s']}")
        out.append("-- engines --")
        engines = s.get("engines") or {}
        if not engines:
            out.append("  (none yet)")
        for eng, ph in sorted(engines.items()):
            kv = " ".join(
                f"{k}={round(v, 3) if isinstance(v, float) else v}"
                for k, v in sorted(ph.items())
                if isinstance(v, (int, float)))
            out.append(f"  {eng}: {kv}")
        out.append("-- stage latency (ms) --")
        hists = s.get("histograms") or {}
        if not hists:
            out.append("  (no samples yet)")
        else:
            out.append(f"  {'stage':<12} {'count':>8} {'p50':>10} "
                       f"{'p90':>10} {'p99':>10} {'max':>10}")
            for stage in _hist.HIST_STAGES:
                h = hists.get(stage)
                if not h:
                    continue
                out.append(f"  {stage:<12} {h['count']:>8} "
                           f"{h['p50_ms']:>10.3f} {h['p90_ms']:>10.3f} "
                           f"{h['p99_ms']:>10.3f} {h['max_ms']:>10.3f}")
        gauges = s.get("gauges") or {}
        hb = gauges.get("mr_worker_heartbeat_age_s")
        out.append("-- heartbeats --")
        if hb:
            out.append("  " + "  ".join(f"{w}={a}s"
                                        for w, a in sorted(hb.items())))
        else:
            out.append("  (no workers)")
        stall = gauges.get("pipeline_stall")
        if stall:
            out.append(f"-- last stall --\n  {stall}")
        if s["counters"]:
            out.append(f"-- counters --\n  {s['counters']}")
        for name, (status_fn, _metrics_fn) in _section_items():
            try:
                body = status_fn()
            except Exception:
                continue  # a broken provider must not kill the scrape
            out.append(f"-- {name} --")
            out.append(body.rstrip("\n") if body else "  (empty)")
        return "\n".join(out) + "\n"

    def metrics_text(self) -> str:
        s = self.snapshot()
        L = [f"dsi_up 1",
             f"dsi_uptime_seconds {s['uptime_s']}",
             f"dsi_live_samples_total {self.samples}",
             f"dsi_trace_dropped_events {s['dropped_events']}"]
        hists = s.get("histograms") or {}
        if hists:
            L.append("# TYPE dsi_stage_latency_seconds summary")
        for stage, h in sorted(hists.items()):
            lab = f'stage="{_mname(stage)}"'
            for q, key in (("0.5", "p50_ms"), ("0.9", "p90_ms"),
                           ("0.99", "p99_ms")):
                L.append(f"dsi_stage_latency_seconds{{{lab},"
                         f'quantile="{q}"}} {h[key] / 1e3:.6g}')
            L.append(f"dsi_stage_latency_seconds_sum{{{lab}}} "
                     f"{h['total_s']}")
            L.append(f"dsi_stage_latency_seconds_count{{{lab}}} "
                     f"{h['count']}")
            L.append(f"dsi_stage_latency_seconds_max{{{lab}}} "
                     f"{h['max_ms'] / 1e3:.6g}")
        for p in s["pipelines"]:
            lab = f'engine="{_mname(p["engine"] or "unknown")}"'
            L.append(f"dsi_pipeline_step{{{lab}}} {p['step']}")
            L.append(f"dsi_pipeline_inflight{{{lab}}} {p['inflight']}")
            L.append(f"dsi_pipeline_oldest_age_seconds{{{lab}}} "
                     f"{p['oldest_age_s']}")
        for eng, ph in sorted((s.get("engines") or {}).items()):
            lab_e = _mname(eng)
            for k, v in sorted(ph.items()):
                if isinstance(v, bool):
                    v = int(v)
                if isinstance(v, (int, float)):
                    L.append(f'dsi_engine_stat{{engine="{lab_e}",'
                             f'key="{_mname(k)}"}} {v}')
        gauges = s.get("gauges") or {}
        hb = gauges.get("mr_worker_heartbeat_age_s") or {}
        for w, a in sorted(hb.items()):
            L.append(f'dsi_worker_heartbeat_age_seconds'
                     f'{{worker="{_mname(w)}"}} {a}')
        for name, v in sorted(s["counters"].items()):
            L.append(f'dsi_counter{{name="{_mname(name)}"}} {v}')
        for name, (_status_fn, metrics_fn) in _section_items():
            if metrics_fn is None:
                continue
            try:
                extra = metrics_fn()
            except Exception:
                continue
            if extra:
                L.append(extra.rstrip("\n"))
        return "\n".join(L) + "\n"

    # ── sampler ──

    def _sample_once(self) -> None:
        try:
            line = json.dumps(self.snapshot(), sort_keys=True,
                              default=str)
        except Exception:
            return
        self.ring.append(line)
        self.samples += 1
        if not self.live_dir:
            return
        try:
            path = os.path.join(self.live_dir, "live.jsonl")
            tmp = f"{path}.tmp-{os.getpid()}"
            # dsicheck: allow[raw-write] bounded live ring, rewritten
            # every sample: temp+rename keeps readers untorn; fsync on
            # a 1 Hz telemetry loop would tax the engine for bytes
            # that are stale one interval later by design
            with open(tmp, "w", encoding="utf-8") as f:
                f.write("\n".join(self.ring) + "\n")
            os.replace(tmp, path)  # atomic: readers never see a torn file
        except OSError:
            pass  # a full disk must not kill the engine

    def _sample_loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._sample_once()

    # ── lifecycle ──

    def start(self) -> "LiveTelemetry":
        _hist.hold()
        live = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # no per-request stderr spam
                pass

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path in ("/", "/statusz"):
                    body, ctype = live.statusz_text(), "text/plain"
                elif path == "/metrics":
                    body, ctype = (live.metrics_text(),
                                   "text/plain; version=0.0.4")
                elif path == "/healthz":
                    body, ctype = '{"ok": true}\n', "application/json"
                else:
                    self.send_error(404)
                    return
                data = body.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._srv = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        if self.live_dir:
            os.makedirs(self.live_dir, exist_ok=True)
        self._sample_once()  # a crash in device init still leaves one
        t_srv = threading.Thread(target=self._srv.serve_forever,
                                 name="dsi-statusz-server", daemon=True)
        t_smp = threading.Thread(target=self._sample_loop,
                                 name="dsi-live-sampler", daemon=True)
        self._threads = [t_srv, t_smp]
        t_srv.start()
        t_smp.start()
        print(f"statusz: serving on http://127.0.0.1:{self.port}/statusz "
              f"(metrics: /metrics"
              + (f"; ring: {os.path.join(self.live_dir, 'live.jsonl')}"
                 if self.live_dir else "") + ")",
              file=sys.stderr, flush=True)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        _hist.release()


# ── the process-global instance (one peephole per process) ─────────────

_live_lock = threading.Lock()
_live: Optional[LiveTelemetry] = None


def start_live(port: int, live_dir: Optional[str] = None) -> LiveTelemetry:
    """Start (or return) the process's live telemetry plane.  ``port``
    0 binds a free port; the chosen one is printed to stderr and
    available as ``.port``."""
    global _live
    with _live_lock:
        if _live is None:
            _live = LiveTelemetry(port=port, live_dir=live_dir).start()
        return _live


def stop_live() -> None:
    global _live
    with _live_lock:
        if _live is not None:
            _live.stop()
            _live = None


def start_from_args(port_arg: Optional[int],
                    live_dir: Optional[str] = None
                    ) -> Optional[LiveTelemetry]:
    """The CLIs' one-liner: an explicit ``--statusz-port`` wins (0 =
    pick a free port), else ``DSI_STATUSZ_PORT`` > 0 enables, else the
    plane stays off (None returned, zero threads)."""
    if port_arg is None:
        env = _env_int("DSI_STATUSZ_PORT", 0)
        if env <= 0:
            return None
        port_arg = env
    return start_live(int(port_arg), live_dir=live_dir)
