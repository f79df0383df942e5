"""Streaming grep on the card, as a command.

Port of ``dsi_tpu/cli/grepstream.py``: the input files become one
bounded-memory block stream cut at newline boundaries, every stream step
runs ONE launch of the grep step kernel (``parallel/grepstream.py``,
kernel J) over ``--devices`` virtual shards, and the result is the
whole-stream match statistics: total / matched lines, occurrences, the
per-line match-count histogram and the exact top-k lines by occurrence
count.  ``--device-accumulate`` keeps the histogram and the top-k
candidate table on the card (``device/topk.py``), pulling every
``--sync-every`` folds instead of every step.

When the engine declines (a non-literal pattern, or a line wider than
``--chunk-bytes``) the host oracle scan produces the result.
``--device cpu`` runs the plain PyTorch versions; the default is the card.

Usage:
    python -m dsi_tpu_torch.cli.grepstream --pattern PAT [--chunk-bytes B]
        [--devices D] [--pipeline-depth D] [--device-accumulate]
        [--sync-every K] [--mesh-shards N] [--topk K] [--ingest-readers N]
        [--stats] [--check] [--device cuda|cpu] inputfiles...
"""

from __future__ import annotations

import argparse
import os
import sys


def _positive_int(s: str) -> int:
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("files", nargs="+")
    p.add_argument("--pattern", default=None,
                   help="literal pattern (default: DSI_GREP_PATTERN)")
    p.add_argument("--chunk-bytes", type=_positive_int, default=1 << 20,
                   help="per-shard bytes per stream step (also the line "
                        "length ceiling: a wider line routes the stream to "
                        "the host scan)")
    p.add_argument("--devices", type=_positive_int, default=1,
                   help="virtual shards (the reference's mesh size), the "
                        "leading tensor dimension on one card")
    p.add_argument("--pipeline-depth", type=_positive_int, default=None,
                   help="in-flight stream steps (default: "
                        "DSI_STREAM_PIPELINE_DEPTH or 2; 1 = synchronous)")
    p.add_argument("--device-accumulate", action="store_true",
                   help="fold histograms and top-k candidates into the "
                        "services on the card and pull only every "
                        "--sync-every folds; results are bit-identical")
    p.add_argument("--sync-every", type=_positive_int, default=None,
                   help="folds between host pulls with --device-accumulate "
                        "(default: DSI_STREAM_SYNC_EVERY or 8)")
    p.add_argument("--mesh-shards", type=int, default=None,
                   help="mesh-shard the services across N of the --devices "
                        "shards (ihash %% N routing inside the fold, "
                        "per-shard widens, pre-merged histogram pulls; "
                        "implies --device-accumulate; default: "
                        "DSI_STREAM_MESH_SHARDS or 0 = off)")
    p.add_argument("--topk", type=_positive_int, default=16,
                   help="top-k lines by occurrence count to report")
    p.add_argument("--ingest-readers", type=int, default=None,
                   dest="ingest_readers",
                   help="parallel mmap'd input readers with readahead "
                        "(utils/ioread.py; default: DSI_INGEST_READERS or "
                        "0 = inline reads)")
    p.add_argument("--stats", action="store_true",
                   help="print the pipeline_stats dict to stderr")
    p.add_argument("--check", action="store_true",
                   help="run the host oracle scan over the same stream and "
                        "verify parity (exit 2 on mismatch)")
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where the step runs (default: cuda; cpu runs the "
                        "plain PyTorch versions)")
    args = p.parse_args(argv)

    pattern = args.pattern or os.environ.get("DSI_GREP_PATTERN")
    if not pattern:
        print("grepstream: no pattern (--pattern or DSI_GREP_PATTERN)",
              file=sys.stderr)
        return 1

    from dsi_tpu_torch.parallel.grepstream import (grep_host_oracle,
                                                   grep_streaming)
    from dsi_tpu_torch.parallel.streaming import stream_files
    from dsi_tpu_torch.utils.ioread import open_blocks

    pstats: dict = {}
    res = grep_streaming(
        open_blocks(args.files, readers=args.ingest_readers), pattern,
        n_dev=args.devices, chunk_bytes=args.chunk_bytes,
        depth=args.pipeline_depth, device_accumulate=args.device_accumulate,
        sync_every=args.sync_every, mesh_shards=args.mesh_shards,
        topk=args.topk, pipeline_stats=pstats, device=args.device)
    if args.stats:
        print(f"grepstream: pipeline_stats={pstats}", file=sys.stderr)
    host_path = res is None
    if host_path:
        try:
            res = grep_host_oracle(stream_files(args.files), pattern,
                                   topk=args.topk)
        except UnicodeEncodeError:
            print("grepstream: pattern is not plain ASCII; use the "
                  "cuda_grep app for regex tiers", file=sys.stderr)
            return 1
        print("grepstream: stream needed the host path; ran the host scan",
              file=sys.stderr)

    print(f"lines={res.lines} matched={res.matched} "
          f"occurrences={res.occurrences}")
    print("hist=" + ",".join(str(h) for h in res.hist))
    for line_no, occ in res.topk:
        print(f"top line={line_no} occ={occ}")

    if args.check and not host_path:
        want = grep_host_oracle(stream_files(args.files), pattern,
                                topk=args.topk)
        if res != want:
            print("grepstream: PARITY FAILURE vs host oracle",
                  file=sys.stderr)
            return 2
        print("grepstream: parity OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
