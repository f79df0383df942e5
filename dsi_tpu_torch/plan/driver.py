"""Plan driver: run a Stage DAG with device-resident handoffs.

Port of ``dsi_tpu/plan/driver.py`` (``run_plan``, the pipelined pair, the
six stage kinds, the shard merges and the df top-k off the resident
table).  Stages run in topological order, each as a step object
(``parallel/stepobj.py``) driven one ``advance()`` at a time, and the edge
between two stages is a relay (``device/relay.py``): stage N+1's upload
IS stage N's device-resident output.  ``staged=True`` swaps every relay
for its host flavour (full materialisation between stages), the baseline
and the parity oracle: the two modes give identical results by
construction.

``run_plan`` runs on ``device`` (None = the card, which raises without
CUDA) over ``n_dev`` virtual shards, the reference's mesh size.  Every
stage launches from the calling thread on its current CUDA stream, so a
relay pack is ordered before the step that reads its buffer.  Stage
commits (``checkpoint_dir``, ``resume``, the fault points) are not ported
yet and raise ``NotImplementedError`` naming their ROADMAP item.

``stats`` receives the reference's ``plan_*`` keys and, until the
metrics registry is ported, each stage's engine stats under
``plan_engine_stats[stage name]`` (a list of dicts for a stage run as
shard attempts).  A chain whose input needs the host path (non-ASCII
bytes, a non-literal pattern, a word longer than 64 bytes) fails loudly
with :class:`PlanHostPath` instead of degrading.
"""

from __future__ import annotations

import os
import queue
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from dsi_tpu_torch.ops.wordcount import resolve_device
from dsi_tpu_torch.parallel.pipeline import timed
from dsi_tpu_torch.parallel.streaming import _not_ported
from dsi_tpu_torch.plan.graph import Plan, PlanError, Stage


class PlanHostPath(RuntimeError):
    """A stage's engine routed to the host path: the chain cannot keep the
    intermediate on the device, and degrading silently would break the
    zero-host-bytes contract — the caller decides what to do."""


class StageOut:
    """One stage's outputs in the driver context: ``result`` (the stage's
    value), ``relay`` (the outgoing byte relay, grep) and ``handoff``
    (exported live services, indexer)."""

    __slots__ = ("result", "relay", "handoff")

    def __init__(self, result=None, relay=None, handoff=None):
        self.result = result
        self.relay = relay
        self.handoff = handoff


class PlanResult:
    """``results[name]`` per stage, ``final`` = the last stage's result,
    ``stats`` = the run's plan scope (``plan_*`` keys)."""

    def __init__(self, results: Dict, final, stats: Dict):
        self.results = results
        self.final = final
        self.stats = stats


def _spill_bytes(plan: Plan) -> int:
    mb = plan.defaults.get("spill_mb")
    if mb is None:
        try:
            mb = float(os.environ.get("DSI_PLAN_SPILL_MB", "0"))
        except ValueError:
            mb = 0.0
    return int(float(mb) * 1e6)


def _drive(step):
    """Advance one step to completion (rung restarts included), then
    close it."""
    while step.advance():
        pass
    return step.close()


def _drive_many(steps):
    """Round-robin the K shard attempts of a stage to completion — one
    ``advance()`` per live step per pass, so their device work
    interleaves."""
    live = list(steps)
    while live:
        live = [st for st in live if st.advance()]
    return [st.close() for st in steps]


def _merge_grep_results(results):
    """Sum-merge K shard-grep results: lines, matched, occurrences and the
    histogram add exactly (shards cut the line stream at newlines); the
    per-shard top-k ranks by shard-local line numbers and is not globally
    mergeable, so the merged result omits it."""
    from dsi_tpu_torch.parallel.grepstream import GrepStreamResult

    hist = None
    lines = matched = occurrences = 0
    for r in results:
        lines += r.lines
        matched += r.matched
        occurrences += r.occurrences
        hist = (list(r.hist) if hist is None
                else [a + b for a, b in zip(hist, r.hist)])
    return GrepStreamResult(lines, matched, occurrences,
                            tuple(hist or ()), ())


def _merge_counts(results):
    """Sum-merge K shard word counts ``{word: (count, part)}``: counts add
    (token-safe cuts), the partition is a function of the word."""
    total: Dict = {}
    for res in results:
        for w, (c, part) in res.items():
            prev = total.get(w)
            total[w] = (c + prev[0] if prev else c, part)
    return total


def _shard_specs(plan: Plan, stage: Stage, stage_shards: int):
    """The stage's shard plan, or None when sharding does not apply: K <
    2, a stage fed by an upstream relay, or a ``data`` source (the
    geometry is file-backed).  The shard scheduler's newline-aligned
    splitter (``mr/shards.py plan_shards``)."""
    if stage_shards <= 1 or stage.deps:
        return None
    paths = plan.param(stage, "paths")
    if not paths:
        return None
    from dsi_tpu_torch.mr.shards import plan_shards

    specs = plan_shards(list(paths), stage_shards)
    return specs if len(specs) > 1 else None


def _spec_blocks(plan: Plan, stage: Stage, spec):
    from dsi_tpu_torch.mr.shards import read_stream_range

    return read_stream_range(list(plan.param(stage, "paths")),
                             spec.start, spec.end)


def _engine_stats(sc: dict, stage: Stage, k: int) -> List[dict]:
    """K fresh engine stats dicts, kept in the plan scope under the
    stage's name (one dict, or the list of the K shard attempts')."""
    dicts = [{} for _ in range(k)]
    sc["plan_engine_stats"][stage.name] = dicts[0] if k == 1 else dicts
    return dicts


# ── the driver ────────────────────────────────────────────────────────


def run_plan(plan: Plan, *, n_dev: int = 1, device=None,
             staged: bool = False, checkpoint_dir: Optional[str] = None,
             resume: bool = False, pipelined: bool = False,
             stage_shards: int = 0,
             stats: Optional[dict] = None) -> PlanResult:
    """Run ``plan`` end to end over ``n_dev`` virtual shards on ``device``
    (None = the card; module docstring).  ``staged=True`` is the host
    materialisation baseline; results are identical to the chained mode.

    ``pipelined=True`` overlaps a grep→wordcount pair: the word count
    consumes relay buffers as they seal while the grep is still producing
    (``plan_overlap_s`` is the wall of consumer advances before the
    producer finished).  Chained mode only.  ``stage_shards=K`` runs a
    file-backed source stage as K newline-aligned shard attempts,
    interleaved and merged.  ``checkpoint_dir`` and ``resume`` are not
    ported yet."""
    if resume and not checkpoint_dir:
        raise PlanError("resume=True requires checkpoint_dir")
    if checkpoint_dir:
        raise _not_ported("checkpoint_dir/resume (stage commits)",
                          "#4c, checkpoints")
    dev = resolve_device(device)
    pipelined = bool(pipelined) and not staged
    stage_shards = max(0, int(stage_shards or 0))
    sc: dict = {"plan_stages": len(plan), "plan_intermediate_bytes": 0,
                "plan_commit_bytes": 0, "plan_resumed_stages": 0,
                "plan_handoff": "host" if staged else "device",
                "plan_pipelined": int(pipelined),
                "plan_stage_shards": stage_shards,
                "plan_overlap_s": 0.0, "plan_s": 0.0, "stage_commit_s": 0.0,
                "plan_stage_walls": {}, "plan_engine_stats": {}}
    order = plan.ordered()
    ctx: Dict[str, StageOut] = {}
    i = 0
    while i < len(order):
        stage = order[i]
        nxt = order[i + 1] if i + 1 < len(order) else None
        if (pipelined and stage.kind == "grep" and not stage.deps
                and nxt is not None and nxt.kind == "wordcount"
                and list(nxt.deps) == [stage.name]):
            # The fused pair: both stages run interleaved.
            t0 = time.perf_counter()
            g_out, w_out, g_wall = _run_pipelined_pair(
                plan, stage, nxt, n_dev, dev, sc, stage_shards)
            ctx[stage.name] = g_out
            ctx[nxt.name] = w_out
            sc["plan_stage_walls"][stage.name] = g_wall
            sc["plan_stage_walls"][nxt.name] = time.perf_counter() - t0
            i += 2
            continue
        t0 = time.perf_counter()
        with timed(sc, "plan_s"):
            out = _run_stage(plan, stage, ctx, n_dev, dev, staged, sc,
                             stage_shards)
        ctx[stage.name] = out
        sc["plan_stage_walls"][stage.name] = time.perf_counter() - t0
        i += 1
    if stats is not None:
        stats.update(sc)
    results = {name: out.result for name, out in ctx.items()}
    return PlanResult(results, ctx[order[-1].name].result, sc)


def _engine_kw(plan: Plan, stage: Stage) -> Dict:
    return {
        "chunk_bytes": int(plan.param(stage, "chunk_bytes", 1 << 20)),
        "depth": plan.param(stage, "depth"),
        "aot": bool(plan.param(stage, "aot", False)),
        "device_accumulate": bool(
            plan.param(stage, "device_accumulate", False)),
        "sync_every": plan.param(stage, "sync_every"),
        "mesh_shards": plan.param(stage, "mesh_shards"),
    }


def _source_blocks(plan: Plan, stage: Stage):
    paths = plan.param(stage, "paths")
    data = plan.param(stage, "data")
    if paths:
        from dsi_tpu_torch.parallel.streaming import stream_files

        return stream_files(list(paths))
    if data is not None:
        return [bytes(data)]
    raise PlanError(f"stage {stage.name!r} has neither paths nor data")


class _RelayFeed:
    """Queue-backed ``device_batches`` iterable for the pipelined handoff:
    the driver ``put``s each buffer the moment the producing relay seals
    it, and the consuming word count's batch feed blocks on the queue.
    The driver advances the consumer only while fed-but-unconsumed
    buffers remain (one pump dispatches exactly one item), so the feed
    never deadlocks."""

    _DONE = object()

    def __init__(self):
        self._q = queue.Queue()

    def put(self, buf) -> None:
        self._q.put(buf)

    def close(self) -> None:
        self._q.put(self._DONE)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                return
            yield item


def _grep_steps(plan: Plan, stage: Stage, relay, n_dev: int, dev, kw,
                sc: dict, stage_shards: int, ctx: Optional[Dict] = None):
    """The stage's grep step(s): K shard steps over newline-aligned byte
    ranges when sharding applies, else one step over the whole source
    (or the upstream relay's line stream — the cascade)."""
    from dsi_tpu_torch.parallel.grepstream import GrepStep

    pattern = plan.param(stage, "pattern")
    topk = int(plan.param(stage, "topk", 16))

    def step(blocks, st):
        return GrepStep(blocks, pattern, n_dev=n_dev, topk=topk,
                        line_sink=relay, pipeline_stats=st, device=dev,
                        **kw)

    if stage.deps:
        up = ctx[stage.deps[0]]
        src = (up.relay.blocks() if hasattr(up.relay, "blocks")
               else up.relay.host_blocks())
        return [step(src, _engine_stats(sc, stage, 1)[0])], False
    specs = _shard_specs(plan, stage, stage_shards)
    if specs is None:
        return [step(_source_blocks(plan, stage),
                     _engine_stats(sc, stage, 1)[0])], False
    return [step(_spec_blocks(plan, stage, spec), st)
            for spec, st in zip(specs, _engine_stats(sc, stage,
                                                     len(specs)))], True


def _wc_kw(plan: Plan, stage: Stage) -> Dict:
    return dict(_engine_kw(plan, stage),
                n_reduce=int(plan.param(stage, "n_reduce", 10)),
                u_cap=int(plan.param(stage, "u_cap", 1 << 12)))


def _run_pipelined_pair(plan: Plan, g_stage: Stage, wc_stage: Stage,
                        n_dev: int, dev, sc: dict, stage_shards: int):
    """The fused grep→wordcount pair: the word count consumes relay
    buffers as they seal while the grep(s) keep producing.  The consumer
    is advanced only while fed-but-unconsumed buffers exist, so the
    interleave never blocks on an empty feed."""
    from dsi_tpu_torch.device.relay import DeviceRelay
    from dsi_tpu_torch.parallel.streaming import WordcountStep

    kw = _engine_kw(plan, g_stage)
    relay = DeviceRelay(n_dev, cap=kw["chunk_bytes"], device=dev, stats=sc,
                        spill_bytes=_spill_bytes(plan))
    gsteps, sharded = _grep_steps(plan, g_stage, relay, n_dev, dev, kw, sc,
                                  stage_shards)
    feed = _RelayFeed()
    wc = WordcountStep([], n_dev=n_dev, device_batches=feed,
                       pipeline_stats=_engine_stats(sc, wc_stage, 1)[0],
                       device=dev, **_wc_kw(plan, wc_stage))
    fed = consumed = 0
    wc_live = True
    t0 = time.perf_counter()
    with timed(sc, "plan_s"):
        live = list(gsteps)
        while live:
            live = [st for st in live if st.advance()]
            for buf in relay.take_sealed():
                feed.put(buf)
                fed += 1
            if wc_live and consumed < fed:
                with timed(sc, "plan_overlap_s"):
                    while wc_live and consumed < fed:
                        wc_live = wc.advance()
                        consumed += 1
        g_results = [st.close() for st in gsteps]
    g_wall = time.perf_counter() - t0
    if any(r is None for r in g_results):
        feed.close()
        wc.abort()
        raise PlanHostPath(f"stage {g_stage.name!r}: grep needs the host "
                           f"path (non-literal pattern or over-wide line)")
    g_res = _merge_grep_results(g_results) if sharded else g_results[0]
    relay.finish()
    for buf in relay.take_sealed():
        feed.put(buf)
        fed += 1
    feed.close()
    with timed(sc, "plan_s"):
        while wc_live:
            wc_live = wc.advance()
        w_res = wc.close()
    if w_res is None:
        raise PlanHostPath(f"stage {wc_stage.name!r}: wordcount needs the "
                           f"host path (non-ASCII or >64-byte word)")
    return StageOut(result=g_res, relay=relay), StageOut(result=w_res), g_wall


def _run_stage(plan: Plan, stage: Stage, ctx: Dict, n_dev: int, dev,
               staged: bool, sc: dict, stage_shards: int = 0) -> StageOut:
    kw = _engine_kw(plan, stage)
    if stage.kind == "grep":
        from dsi_tpu_torch.device.relay import DeviceRelay, HostRelay

        relay = (HostRelay(stats=sc) if staged
                 else DeviceRelay(n_dev, cap=kw["chunk_bytes"], device=dev,
                                  stats=sc, spill_bytes=_spill_bytes(plan)))
        steps, sharded = _grep_steps(plan, stage, relay, n_dev, dev, kw, sc,
                                     stage_shards, ctx)
        results = _drive_many(steps) if sharded else [_drive(steps[0])]
        if any(r is None for r in results):
            raise PlanHostPath(f"stage {stage.name!r}: grep needs the host "
                               f"path (non-literal pattern or over-wide "
                               f"line)")
        if sharded:
            res = _merge_grep_results(results)
        else:
            res = results[0]
            if stage.deps:
                # A cascade stage's line numbers follow the relay's buffer
                # order, which differs between the two handoff modes: drop
                # the (line_no, occ) ranks so the modes stay comparable.
                res = res._replace(topk=())
        return StageOut(result=res, relay=relay)

    if stage.kind == "wordcount":
        from dsi_tpu_torch.parallel.streaming import WordcountStep

        wc_kw = dict(_wc_kw(plan, stage), n_dev=n_dev, device=dev)
        if stage.deps:
            up = ctx[stage.deps[0]]
            st = _engine_stats(sc, stage, 1)[0]
            if hasattr(up.relay, "blocks"):  # staged: a host block stream
                step = WordcountStep(up.relay.blocks(), pipeline_stats=st,
                                     **wc_kw)
            else:
                step = WordcountStep([], device_batches=up.relay.batches(),
                                     pipeline_stats=st, **wc_kw)
            res = _drive(step)
            if res is None:
                raise PlanHostPath(f"stage {stage.name!r}: wordcount needs "
                                   f"the host path (non-ASCII or >64-byte "
                                   f"word)")
            return StageOut(result=res)
        # A source word count: one stream, or K shard attempts.
        specs = _shard_specs(plan, stage, stage_shards)
        if specs is None:
            steps = [WordcountStep(_source_blocks(plan, stage),
                                   pipeline_stats=_engine_stats(
                                       sc, stage, 1)[0], **wc_kw)]
        else:
            steps = [WordcountStep(_spec_blocks(plan, stage, spec),
                                   pipeline_stats=st, **wc_kw)
                     for spec, st in zip(specs, _engine_stats(
                         sc, stage, len(specs)))]
        results = _drive_many(steps) if len(steps) > 1 \
            else [_drive(steps[0])]
        if any(r is None for r in results):
            raise PlanHostPath(f"stage {stage.name!r}: wordcount needs the "
                               f"host path (non-ASCII or >64-byte word)")
        return StageOut(result=results[0] if len(results) == 1
                        else _merge_counts(results))

    if stage.kind == "top_k":
        k = int(plan.param(stage, "topk", 16))
        counts = ctx[stage.deps[0]].result
        return StageOut(result=tuple(sorted(
            ((int(c), w) for w, (c, _p) in counts.items()),
            key=lambda r: (-r[0], r[1]))[:k]))

    if stage.kind == "indexer":
        from dsi_tpu_torch.parallel.grepstream import IndexerStep

        step = IndexerStep(list(plan.param(stage, "docs")), n_dev=n_dev,
                           n_reduce=int(plan.param(stage, "n_reduce", 10)),
                           u_cap=int(plan.param(stage, "u_cap", 1 << 15)),
                           topk=int(plan.param(stage, "topk", 16)),
                           keep_services=not staged,
                           depth=kw["depth"],
                           device_accumulate=kw["device_accumulate"],
                           sync_every=kw["sync_every"],
                           mesh_shards=kw["mesh_shards"],
                           stats=_engine_stats(sc, stage, 1)[0], device=dev)
        res = _drive(step)
        if res is None:
            raise PlanHostPath(f"stage {stage.name!r}: indexer needs the "
                               f"host path (non-ASCII or >64-byte word)")
        if staged:
            return StageOut(result=res)
        return StageOut(result=None, handoff=step.exported)

    if stage.kind == "df_topk":
        k = int(plan.param(stage, "topk", 16))
        up = ctx[stage.deps[0]]
        if up.handoff is None:  # the staged indexer's result
            _, top = up.result
            return StageOut(result=tuple(top[:k]))
        return StageOut(result=_df_topk_from_handoff(up.handoff, k))

    if stage.kind == "postings_join":
        up_idx = ctx[stage.deps[0]]
        top = ctx[stage.deps[1]].result
        words = [w for _, w in top]
        if up_idx.handoff is None:
            postings, _ = up_idx.result
            join = {w: (df, postings[w][0], tuple(postings[w][1]))
                    for df, w in top if w in postings}
        else:
            h = up_idx.handoff
            if h.get("postings_svc") is not None:
                h["postings_svc"].close()  # flush the device buffer's
                h["postings_svc"] = None  # remainder into the table
            packed = h["table"].finalize_packed()
            found = packed.lookup_many(words)
            join = {w: (df, found[w][0], tuple(d for d, _ in found[w][1]))
                    for df, w in top if w in found}
        return StageOut(result=join)

    raise PlanError(f"unrunnable stage kind {stage.kind!r}")


def _df_topk_from_handoff(h: Dict, k: int) -> Tuple:
    """The chained df top-k: a k-row snapshot off the resident df table
    (no drain to the host) when it holds the complete state; the exact
    drain when a widen already moved rows into the host accumulator (or
    there is no device table) — the fallback costs pulls, never
    exactness."""
    from dsi_tpu_torch.ops.wordcount import decode_packed

    tk = h.get("topk_svc")
    df_acc = h["df_acc"]
    residue = bool(df_acc.snapshot())
    if tk is not None and not residue:
        tk.sync()  # flushes the fold lag, pulls k rows a shard
        out = []
        for c, keys, ln in tk.snapshot:
            w = decode_packed(np.array([keys], np.uint32),
                              np.array([int(ln)]), 1)[0]
            out.append((int(c), w))
        h["topk_svc"] = None  # the table is never drained: drop it
        return tuple(out[:k])
    if tk is not None:
        tk.close()  # exact drain into df_acc (the widen-residue path)
        h["topk_svc"] = None
    dfm = {w: c for w, (c, _p) in df_acc.finalize().items()}
    if not dfm:
        # The host-merge indexer (no device table): the document frequency
        # is the postings list's length; close any device buffer first.
        if h.get("postings_svc") is not None:
            h["postings_svc"].close()
            h["postings_svc"] = None
        dfm = {w: int(e - s) for w, s, e in _word_spans(h["table"])}
    return tuple(sorted(((c, w) for w, c in dfm.items()),
                        key=lambda r: (-r[0], r[1]))[:k])


def _word_spans(table):
    from dsi_tpu_torch.ops.wordcount import decode_packed

    packed = table.finalize_packed()
    words = decode_packed(packed.skeys, packed.lens, len(packed.skeys))
    for i, w in enumerate(words):
        yield w, int(packed.starts[i]), int(packed.ends[i])
