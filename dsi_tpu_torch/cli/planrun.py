"""Multi-stage dataflow plans on the card: chained jobs, no host round trip.

Port of ``dsi_tpu/cli/planrun.py``.  Runs one of the canonical plans
(``dsi_tpu_torch/plan``) end to end: stages run as step objects and the
intermediate between them stays on the card (stage N+1's upload is stage
N's output, ``device/relay.py``), against the ``--staged`` baseline that
materialises every intermediate through the host.

Chains:
  grep-wc   — grep → word count over exactly the matching lines; writes
              the word counts as mr-out-<r> files in --workdir.
  grep-grep — grep → grep: lines with --pattern, of those, lines with
              --pattern2; writes plan-grep.json with the match counts.
  wc-topk   — word count → the top-k highest-count words; writes
              plan-topk.json.
  indexer   — indexer → df top-k (a k-row snapshot off the resident df
              table) → per-term postings join; writes plan-join.json.

``--pipeline`` overlaps a grep→wordcount pair (the word count consumes
relay buffers as they seal); ``--stage-shards K`` runs a file-backed
source stage as K newline-aligned shard attempts.  ``--checkpoint-dir``
commits each completed stage durably; ``--resume`` skips every stage whose
manifest verifies and goes on from the last one (the stores are the
reference's, so either package resumes the other's).  ``--device cpu``
runs the plain PyTorch versions; the default is the card.  ``--hosts``,
``--trace-dir`` and ``--aot`` are not ported yet and exit with an error
naming their ROADMAP item.

Usage:
    python -m dsi_tpu_torch.cli.planrun --chain grep-wc --pattern PAT
        [--pattern2 PAT] [--pipeline] [--stage-shards K]
        [--checkpoint-dir DIR [--resume]] [--staged] [--chunk-bytes B] [--devices D] [--pipeline-depth K]
        [--device-accumulate] [--sync-every K] [--mesh-shards N]
        [--nreduce N] [--u-cap U] [--topk K] [--workdir DIR] [--check]
        [--stats] [--stats-json FILE] [--device cuda|cpu] inputfiles...
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# Options of the reference's planrun that wait for a later part of the
# port, with the ROADMAP item that brings them.
_NOT_PORTED = {
    "hosts": "--hosts (net-served relays) is not ported yet (ROADMAP "
             "Queue 1, #5, the control plane)",
    "trace_dir": "--trace-dir is not ported yet (ROADMAP Queue 1, #5, "
                 "obs/)",
    "aot": "--aot is not ported yet (ROADMAP Queue 1, #7, the kernel "
           "build/warm cache)",
}


def _positive_int(s: str) -> int:
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def _plan_spec(args) -> dict:
    """The plan-rebuild spec (``plan.stagehost.build_plan``'s input) this
    argv describes."""
    return {"chain": args.chain, "pattern": args.pattern,
            "pattern2": args.pattern2, "files": list(args.files),
            "chunk_bytes": args.chunk_bytes, "depth": args.pipeline_depth,
            "device_accumulate": args.device_accumulate,
            "sync_every": args.sync_every,
            "mesh_shards": args.mesh_shards, "aot": False,
            "n_reduce": args.nreduce, "u_cap": args.u_cap,
            "topk": args.topk, "devices": args.devices}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("files", nargs="+")
    p.add_argument("--chain",
                   choices=("grep-wc", "grep-grep", "wc-topk", "indexer"),
                   default="grep-wc")
    p.add_argument("--pattern", default=None,
                   help="literal grep pattern (required for grep-wc and "
                        "grep-grep)")
    p.add_argument("--pattern2", default=None,
                   help="second-stage literal pattern (required for "
                        "grep-grep)")
    p.add_argument("--pipeline", action="store_true",
                   help="overlap a grep→wordcount pair: stage N+1 consumes "
                        "sealed relay buffers while stage N still produces "
                        "(chained mode only)")
    p.add_argument("--stage-shards", type=int, default=0,
                   help="run a file-backed source stage as K shard "
                        "attempts (0 = off)")
    p.add_argument("--staged", action="store_true",
                   help="run the host-materialisation baseline: every "
                        "intermediate is pulled to the host and fed again; "
                        "results are identical to the chained default")
    p.add_argument("--chunk-bytes", type=_positive_int, default=1 << 20)
    p.add_argument("--devices", type=_positive_int, default=1,
                   help="virtual shards (the reference's mesh size), the "
                        "leading tensor dimension on one card")
    p.add_argument("--pipeline-depth", type=_positive_int, default=None)
    p.add_argument("--device-accumulate", action="store_true")
    p.add_argument("--sync-every", type=_positive_int, default=None)
    p.add_argument("--mesh-shards", type=int, default=None)
    p.add_argument("--nreduce", type=_positive_int, default=10)
    p.add_argument("--u-cap", type=_positive_int, default=1 << 12)
    p.add_argument("--topk", type=_positive_int, default=16)
    p.add_argument("--workdir", default=".")
    p.add_argument("--check", action="store_true",
                   help="also run the other handoff mode (staged vs "
                        "chained) in process and verify the results are "
                        "identical (exit 2 otherwise)")
    p.add_argument("--stats", action="store_true")
    p.add_argument("--stats-json", default=None,
                   help="write the plan stats (plan_* keys) as JSON there")
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where the stages run (default: cuda; cpu runs the "
                        "plain PyTorch versions)")
    p.add_argument("--hosts", action="store_true", help=_NOT_PORTED["hosts"])
    p.add_argument("--checkpoint-dir", default=None,
                   help="stage commits land here: each completed stage "
                        "writes a durable manifest (ckpt/store.py) — see "
                        "--resume")
    p.add_argument("--resume", action="store_true",
                   help="skip every stage whose manifest verifies and go "
                        "on from the last completed stage's commit")
    p.add_argument("--trace-dir", default=None, help=_NOT_PORTED["trace_dir"])
    p.add_argument("--aot", action="store_true", help=_NOT_PORTED["aot"])
    args = p.parse_args(argv)

    if args.hosts:
        p.error(_NOT_PORTED["hosts"])
    if args.trace_dir:
        p.error(_NOT_PORTED["trace_dir"])
    if args.aot:
        p.error(_NOT_PORTED["aot"])
    if args.resume and not args.checkpoint_dir:
        p.error("--resume requires --checkpoint-dir")
    if args.hosts and (args.checkpoint_dir or args.resume):
        # Unreachable while --hosts is refused above; kept with the
        # reference's wording for when ROADMAP Queue 1 #5 brings --hosts.
        p.error("--hosts has its own commit surface (sealed stage "
                "payloads); --checkpoint-dir/--resume are the in-process "
                "stage-manifest path")
    if args.chain in ("grep-wc", "grep-grep") and not args.pattern:
        p.error(f"--chain {args.chain} requires --pattern")
    if args.chain == "grep-grep" and not args.pattern2:
        p.error("--chain grep-grep requires --pattern2")
    if args.pipeline and args.staged:
        p.error("--pipeline is chained-mode only (staged execution stays "
                "strictly sequential: it is the parity oracle)")

    from dsi_tpu_torch.ckpt import CheckpointMismatch
    from dsi_tpu_torch.plan import PlanHostPath, run_plan
    from dsi_tpu_torch.plan.stagehost import build_plan

    spec = _plan_spec(args)
    stats: dict = {}
    try:
        res = run_plan(build_plan(spec), n_dev=args.devices,
                       device=args.device, staged=args.staged,
                       checkpoint_dir=args.checkpoint_dir,
                       resume=args.resume, pipelined=args.pipeline,
                       stage_shards=args.stage_shards, stats=stats)
    except CheckpointMismatch as e:
        print(f"planrun: {e}", file=sys.stderr)
        return 1
    except PlanHostPath as e:
        # The chain's contract is device-resident intermediates; run the
        # standalone engines (wcstream, grepstream) for such inputs.
        print(f"planrun: {e}", file=sys.stderr)
        return 1

    if args.resume:
        print(f"planrun: resumed past {stats.get('plan_resumed_stages', 0)}"
              f" committed stage(s)", file=sys.stderr)
    for name, wall in stats.get("plan_stage_walls", {}).items():
        print(f"planrun: stage {name}: {wall}s", file=sys.stderr)
    print(f"planrun: handoff={stats.get('plan_handoff')} "
          f"intermediate_bytes={stats.get('plan_intermediate_bytes')} "
          f"commit_bytes={stats.get('plan_commit_bytes')}",
          file=sys.stderr)

    os.makedirs(args.workdir, exist_ok=True)
    if args.chain == "grep-wc":
        from dsi_tpu_torch.parallel.shuffle import write_partitioned_output

        g = res.results["grep"]
        print(f"planrun: grep lines={g.lines} matched={g.matched} "
              f"occurrences={g.occurrences}", file=sys.stderr)
        write_partitioned_output(res.final, args.nreduce, args.workdir)
    elif args.chain == "grep-grep":
        stages = {name: {"lines": r.lines, "matched": r.matched,
                         "occurrences": r.occurrences}
                  for name, r in res.results.items()}
        path = os.path.join(args.workdir, "plan-grep.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(stages, f, sort_keys=True, indent=1)
        g2 = res.final
        print(f"planrun: cascade matched={g2.matched} "
              f"occurrences={g2.occurrences} -> {path}", file=sys.stderr)
    elif args.chain == "wc-topk":
        path = os.path.join(args.workdir, "plan-topk.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"topk": [[int(c), w] for c, w in res.final]},
                      f, sort_keys=True, indent=1)
        print(f"planrun: top-{len(res.final)} words -> {path}",
              file=sys.stderr)
    else:
        out = {w: {"df": df, "part": part, "docs": list(docs)}
               for w, (df, part, docs) in res.final.items()}
        path = os.path.join(args.workdir, "plan-join.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"topk": [[c, w] for c, w in
                                res.results.get("dftopk", ())],
                       "join": out}, f, sort_keys=True, indent=1)
        print(f"planrun: join of {len(out)} terms -> {path}",
              file=sys.stderr)

    if args.stats:
        print(f"planrun: plan_stats={stats}", file=sys.stderr)
    if args.stats_json:
        with open(args.stats_json, "w", encoding="utf-8") as f:
            json.dump(stats, f, default=str)

    if args.check:
        # The twin runs the other handoff mode under the same shard
        # fan-out: a stage-sharded grep merge drops the order-sensitive
        # top-k, so parity holds only shard geometry to like.
        twin = run_plan(build_plan(spec), n_dev=args.devices,
                        device=args.device, staged=not args.staged,
                        stage_shards=args.stage_shards)
        ok = twin.final == res.final
        if args.chain == "grep-wc":
            ok = ok and twin.results["grep"] == res.results["grep"]
        elif args.chain == "grep-grep":
            ok = ok and twin.results == res.results
        if not ok:
            print("planrun: PARITY FAILURE chained vs staged",
                  file=sys.stderr)
            return 2
        print("planrun: parity OK (chained vs staged)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
