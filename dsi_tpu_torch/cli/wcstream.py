"""Streaming SPMD word count on the card, as a command.

Port of ``dsi_tpu/cli/wcstream.py``: the input files become one
bounded-memory block stream, every stream step runs the port's
map / shuffle / reduce step over ``--devices`` virtual shards
(``parallel/streaming.py``), and the output is the partitioned
``mr-out-<r>`` file set (``mr/worker.go:126-148`` layout, ``ihash %
NReduce`` partitioning).  When the stream needs the host path (non-ASCII
bytes, words over 64 letters) the host word count produces the same
files.  ``--device cpu`` runs the plain PyTorch versions; the default is
the card.

Usage:
    python -m dsi_tpu_torch.cli.wcstream [--nreduce N] [--chunk-bytes B]
        [--devices D] [--workdir DIR] [--check] [--u-cap U]
        [--pipeline-depth D] [--device-accumulate] [--sync-every K]
        [--mesh-shards N] [--grouper sort|hash] [--ingest-readers N]
        [--wire-upload] [--stats] [--device cuda|cpu] inputfiles...
"""

from __future__ import annotations

import argparse
import os
import sys


def _positive_int(s: str) -> int:
    """argparse type: capacities and sizes must be >= 1 (a 0 capacity
    could never widen in the exactness_retry ladder)."""
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("files", nargs="+")
    p.add_argument("--nreduce", type=_positive_int, default=10)
    p.add_argument("--chunk-bytes", type=_positive_int, default=1 << 20,
                   help="per-shard bytes per stream step")
    p.add_argument("--devices", type=_positive_int, default=1,
                   help="virtual shards (the reference's mesh size), the "
                        "leading tensor dimension on one card")
    p.add_argument("--workdir", default=".")
    p.add_argument("--check", action="store_true",
                   help="run the sequential oracle and verify parity "
                        "(sort mr-out-* | grep . vs oracle)")
    p.add_argument("--u-cap", type=_positive_int, default=1 << 12,
                   help="starting per-shard unique capacity (sticky; "
                        "widens on overflow)")
    p.add_argument("--pipeline-depth", type=_positive_int, default=None,
                   help="in-flight stream steps (default: "
                        "DSI_STREAM_PIPELINE_DEPTH or 2; 1 = synchronous)")
    p.add_argument("--device-accumulate", action="store_true",
                   help="fold confirmed steps into the table on the card "
                        "and pull it only every --sync-every folds; "
                        "results are bit-identical")
    p.add_argument("--sync-every", type=_positive_int, default=None,
                   help="folds between host pulls with "
                        "--device-accumulate (default: "
                        "DSI_STREAM_SYNC_EVERY or 8)")
    p.add_argument("--mesh-shards", type=int, default=None,
                   help="mesh-shard the device table across N of the "
                        "--devices shards (ihash(key) %% N routing inside "
                        "the fold, per-shard widens; implies "
                        "--device-accumulate; default: "
                        "DSI_STREAM_MESH_SHARDS or 0 = off; results are "
                        "the same either way)")
    p.add_argument("--grouper", choices=("sort", "hash"), default=None,
                   help="pin the token-grouping strategy (sets "
                        "DSI_WC_GROUPER; default: hash on the CPU, sort on "
                        "the card); the sort grouper stays the "
                        "always-exact fallback rung either way")
    p.add_argument("--ingest-readers", type=int, default=None,
                   dest="ingest_readers",
                   help="parallel mmap'd input readers with readahead "
                        "(utils/ioread.py; default: DSI_INGEST_READERS or "
                        "0 = inline reads)")
    p.add_argument("--wire-upload", action="store_true", default=None,
                   dest="wire_upload",
                   help="compress chunk uploads on the host and decode them "
                        "on the card (ops/wirecodec.py, kernel N): the link "
                        "moves 0.63-0.88x the bytes, the step reads the "
                        "same chunk (env DSI_STREAM_WIRE; results are the "
                        "same either way)")
    p.add_argument("--stats", action="store_true",
                   help="print the pipeline_stats dict to stderr")
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where the step runs (default: cuda; cpu runs "
                        "the plain PyTorch versions)")
    args = p.parse_args(argv)
    if args.grouper:
        os.environ["DSI_WC_GROUPER"] = args.grouper

    from dsi_tpu_torch.parallel.shuffle import write_partitioned_output
    from dsi_tpu_torch.parallel.streaming import wordcount_streaming
    from dsi_tpu_torch.utils.ioread import open_blocks

    pstats: dict = {}
    acc = wordcount_streaming(
        open_blocks(args.files, readers=args.ingest_readers),
        n_dev=args.devices, n_reduce=args.nreduce,
        chunk_bytes=args.chunk_bytes, u_cap=args.u_cap,
        depth=args.pipeline_depth,
        device_accumulate=args.device_accumulate,
        sync_every=args.sync_every, mesh_shards=args.mesh_shards,
        pipeline_stats=pstats, wire_upload=args.wire_upload,
        device=args.device)
    if args.stats:
        print(f"wcstream: pipeline_stats={pstats}", file=sys.stderr)
    if acc is None:
        # The reference's exactness escape: the oracle's semantics on the
        # host, partitioned the same way.
        print("wcstream: stream needs the host path; running host word count",
              file=sys.stderr)
        from dsi_tpu_torch.serve.pack import host_wordcount

        acc = host_wordcount(args.files, args.nreduce)
    os.makedirs(args.workdir, exist_ok=True)
    write_partitioned_output(acc, args.nreduce, args.workdir)

    if args.check:
        from dsi_tpu_torch.apps import wc
        from dsi_tpu_torch.mr.sequential import run_sequential

        oracle_out = os.path.join(args.workdir, "mr-correct.txt")
        run_sequential(wc.Map, wc.Reduce, args.files, oracle_out)
        got: list = []
        for r in range(args.nreduce):
            with open(os.path.join(args.workdir, f"mr-out-{r}"),
                      encoding="utf-8") as f:
                got.extend(l for l in f if l.strip())
        with open(oracle_out, encoding="utf-8") as f:
            want = sorted(l for l in f if l.strip())
        if sorted(got) != want:
            print("wcstream: PARITY FAILURE vs sequential oracle",
                  file=sys.stderr)
            return 2
        print("wcstream: parity OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
