"""Log-bucketed latency histograms — the live tail-latency view.

Copy of ``dsi_tpu/obs/hist.py``.

The paper's coordinator reacts to stragglers with a flat 10-second
timeout because it has no distributional view of task latency; Dean &
Ghemawat §3.6 make backup-task dispatch a *tail-latency* decision.  This
module is the distribution: an HDR-style histogram whose buckets are
log-spaced (4 sub-buckets per power of two over microseconds), so

* memory is constant (one small int array) however long the run,
* any duration from 1 µs to hours lands in O(1) with one ``frexp``,
* a reported percentile is within one sub-bucket (≤ ~12% relative) of
  the true value — plenty for "is this step 4× its p99" decisions,
* two histograms merge by adding bucket counts (the property the
  hypothesis test pins), so per-process histograms roll up exactly.

:data:`HIST_STAGES` pins which span names are recorded: the hot stages
of the pipeline (``obs/trace.py`` feeds every closing span through
:func:`active_histograms`; non-hot names cost one dict miss).  The
whole plane is OFF by default — ``_active`` is ``None`` until tracing
is enabled or the live sampler (``obs/live.py``) starts, and the
disabled check is a single module-attribute load on the span path.

This module is also the neutral ground for the live plane's shared
state: the pipeline registry (:func:`register_pipeline`) that lets the
sampler and the stall watchdog see in-flight step state without
``parallel/pipeline.py`` importing the HTTP half.
"""

from __future__ import annotations

import math
import os
import threading
import weakref
from typing import Dict, Iterable, List, Optional


def env_float(name: str, default: float) -> float:
    """Float env knob with a default — the live plane's one parser
    (the watchdog, the sampler, and the endpoints all read knobs)."""
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default

#: The span names recorded into stage histograms — the pipeline's hot
#: stages.  Pinned: the registry schema contract test asserts this exact
#: set, and ``/statusz``, ``/metrics``, trace meta, and tracecat's
#: percentile table all key on it.
HIST_STAGES = ("kernel", "upload", "pull", "finish", "fold", "sync",
               "ckpt_commit")

#: The keys every histogram snapshot carries — pinned like HIST_STAGES.
HIST_SNAPSHOT_KEYS = ("count", "total_s", "p50_ms", "p90_ms", "p99_ms",
                      "max_ms")

_SUB = 4                     # sub-buckets per power of two
_NBUCKETS = 64 * _SUB        # 1 µs .. 2^64 µs — covers any real span


class LatencyHistogram:
    """One log-bucketed duration distribution (module docstring).

    ``record`` is the hot path: one ``frexp``, one list increment,
    under a lock (recording happens from the engine thread, the
    producer thread, and the commit worker at once).  Everything else
    is read-side and cheap.
    """

    __slots__ = ("_counts", "count", "total_s", "max_s", "_lock")

    def __init__(self):
        self._counts: List[int] = [0] * _NBUCKETS
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self._lock = threading.Lock()

    @staticmethod
    def bucket_of(seconds: float) -> int:
        """Bucket index for a duration: 4 linear sub-buckets per power
        of two of microseconds; everything under 1 µs is bucket 0."""
        v = seconds * 1e6
        if v < 1.0:
            return 0
        m, e = math.frexp(v)          # v = m * 2^e, m in [0.5, 1)
        b = (e - 1) * _SUB + int((m - 0.5) * (2 * _SUB))
        return b if b < _NBUCKETS else _NBUCKETS - 1

    @staticmethod
    def bucket_mid_s(b: int) -> float:
        """The bucket's midpoint in seconds — what a percentile
        reports (max relative error: half a sub-bucket)."""
        octave, k = divmod(b, _SUB)
        return (2.0 ** octave) * (1.0 + (k + 0.5) / _SUB) / 1e6

    def record(self, seconds: float) -> None:
        b = self.bucket_of(seconds)
        with self._lock:
            self._counts[b] += 1
            self.count += 1
            self.total_s += seconds
            if seconds > self.max_s:
                self.max_s = seconds

    def merge(self, other: "LatencyHistogram") -> None:
        """Fold ``other`` into this histogram (bucket-exact: merging
        equals having recorded every sample here)."""
        with other._lock:
            oc = list(other._counts)
            on, ot, om = other.count, other.total_s, other.max_s
        with self._lock:
            for b, c in enumerate(oc):
                if c:
                    self._counts[b] += c
            self.count += on
            self.total_s += ot
            if om > self.max_s:
                self.max_s = om

    def percentile(self, q: float) -> float:
        """The q-quantile (0 < q <= 1) in seconds, to bucket
        resolution; 0.0 when empty.  The top bucket answers with the
        exact observed max rather than a bucket midpoint above it."""
        with self._lock:
            n = self.count
            counts = list(self._counts)
            mx = self.max_s
        if n == 0:
            return 0.0
        target = max(1, math.ceil(q * n))
        cum = 0
        for b, c in enumerate(counts):
            if not c:
                continue
            cum += c
            if cum >= target:
                return min(self.bucket_mid_s(b), mx)
        return mx

    def snapshot(self) -> Dict:
        """JSON-ready summary under the pinned HIST_SNAPSHOT_KEYS."""
        return {
            "count": self.count,
            "total_s": round(self.total_s, 4),
            "p50_ms": round(1e3 * self.percentile(0.50), 4),
            "p90_ms": round(1e3 * self.percentile(0.90), 4),
            "p99_ms": round(1e3 * self.percentile(0.99), 4),
            "max_ms": round(1e3 * self.max_s, 4),
        }


class KeyedHistograms:
    """A bounded map of :class:`LatencyHistogram` per dynamic key — the
    serving daemon's per-TENANT step-latency view (``serve/daemon.py``
    feeds every packed-step wall to each participating tenant's
    histogram, and tail-driven eviction asks "whose p99 hurts the pack
    most").  Unlike :class:`StageHistograms` the key set is unbounded
    input (tenant ids), so memory is capped: past ``max_keys`` the
    least-recently-RECORDED key is dropped — a tenant idle long enough
    to be displaced by thousands of newer ones has no live tail worth
    evicting on, and a dropped tenant simply re-enters cold.
    """

    def __init__(self, max_keys: int = 4096):
        self._max = max(1, int(max_keys))
        self._h: Dict[str, LatencyHistogram] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._h)

    def record(self, key: str, seconds: float) -> None:
        with self._lock:
            h = self._h.pop(key, None)
            if h is None:
                h = LatencyHistogram()
                while len(self._h) >= self._max:
                    # dicts iterate in insertion order; re-inserting on
                    # every record makes the first key the LRU one.
                    self._h.pop(next(iter(self._h)))
            self._h[key] = h
        h.record(seconds)

    def get(self, key: str) -> Optional[LatencyHistogram]:
        with self._lock:
            return self._h.get(key)

    def drop(self, key: str) -> None:
        """Forget one key (a tenant whose jobs are all done)."""
        with self._lock:
            self._h.pop(key, None)

    def p99_ms(self, key: str) -> float:
        h = self.get(key)
        return round(1e3 * h.percentile(0.99), 4) if h is not None \
            else 0.0

    def top(self, n: int) -> List[tuple]:
        """The ``n`` keys with the worst p99, as ``(key, p99_seconds,
        count)`` tuples sorted worst-first — the eviction policy's and
        the bounded /metrics emission's read side."""
        with self._lock:
            items = list(self._h.items())
        rows = [(k, h.percentile(0.99), h.count) for k, h in items]
        rows.sort(key=lambda r: (-r[1], r[0]))
        return rows[:n]


class StageHistograms:
    """One :class:`LatencyHistogram` per hot stage; ``record`` drops
    non-hot names with a single dict miss."""

    def __init__(self, stages: Iterable[str] = HIST_STAGES):
        self._h: Dict[str, LatencyHistogram] = {
            s: LatencyHistogram() for s in stages}

    def record(self, name: str, seconds: float) -> None:
        h = self._h.get(name)
        if h is not None:
            h.record(seconds)

    def get(self, name: str) -> Optional[LatencyHistogram]:
        return self._h.get(name)

    def snapshot(self) -> Dict[str, Dict]:
        """Non-empty stages only — an idle stage would read as
        "measured zero" when it was never exercised."""
        return {s: h.snapshot() for s, h in self._h.items() if h.count}


# ── activation: the one switch the span path checks ────────────────────

_lock = threading.Lock()
_active: Optional[StageHistograms] = None
_holds = 0  # live-sampler holds: tracing toggles cannot deactivate these


def activate() -> StageHistograms:
    """Turn stage-histogram recording on (idempotent; keeps whatever
    was already recorded).  Called when tracing is enabled and when the
    live sampler starts."""
    global _active
    with _lock:
        if _active is None:
            _active = StageHistograms()
        return _active


def deactivate(force: bool = False) -> None:
    """Turn recording off and drop the histograms — unless a live
    sampler still holds the plane (``force`` overrides, for tests)."""
    global _active, _holds
    with _lock:
        if _holds > 0 and not force:
            return
        if force:
            _holds = 0
        _active = None


def hold() -> StageHistograms:
    """Activate with a hold: the live sampler's entry — a tracer being
    switched off mid-run must not drop the sampler's histograms."""
    global _holds
    with _lock:
        _holds += 1
    return activate()


def release() -> None:
    """Drop one hold (the sampler stopping); recording stays on until
    an explicit deactivate (a still-enabled tracer keeps feeding it)."""
    global _holds
    with _lock:
        _holds = max(0, _holds - 1)


def active_histograms() -> Optional[StageHistograms]:
    """The live stage histograms, or None when the plane is off — THE
    check the span-close path and the pipeline watchdog make."""
    return _active


# ── live pipeline registry (read by the sampler + watchdog) ────────────

_pipelines: "weakref.WeakSet" = weakref.WeakSet()
_pipelines_lock = threading.Lock()


def register_pipeline(pipe) -> None:
    """Track a running ``StepPipeline`` so ``/statusz`` can report its
    in-flight window.  Weak: a pipeline that ends (or errors) without
    unregistering just vanishes.  Locked against the reader — an HTTP
    scrape iterating while an engine thread registers must not die."""
    with _pipelines_lock:
        _pipelines.add(pipe)


def unregister_pipeline(pipe) -> None:
    with _pipelines_lock:
        _pipelines.discard(pipe)


def live_pipelines() -> list:
    with _pipelines_lock:
        try:
            return list(_pipelines)
        except RuntimeError:  # a GC weakref callback mid-iteration
            return []
