"""The crash-test model checker, as a command.

Port of ``dsi_tpu/cli/crashcheck.py``: model-checks ``-n`` randomized
MapReduce jobs (``parallel/simulate.py``; kernel O on the card) and prints
one JSON line of the aggregate invariants.  Exits 0 when every instance
finished, is consistent and is safe, else 1.  ``--device cpu`` runs the
plain PyTorch version; the default is the card.

Usage:
    python -m dsi_tpu_torch.cli.crashcheck [-n 1000] [--exit-prob 0.25]
        [--stall-prob 0.2] [--timeout 10] [--horizon 800] [--n-map 8]
        [--n-reduce 10] [--n-workers 3] [--seed 0] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-n", "--instances", type=int, default=1000)
    p.add_argument("--exit-prob", type=float, default=0.25)
    p.add_argument("--stall-prob", type=float, default=0.2)
    p.add_argument("--timeout", type=int, default=10)
    p.add_argument("--horizon", type=int, default=800)
    p.add_argument("--n-map", type=int, default=8)
    p.add_argument("--n-reduce", type=int, default=10)
    p.add_argument("--n-workers", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where the instances run (default: cuda; cpu runs "
                        "the plain PyTorch version)")
    args = p.parse_args(argv)

    from dsi_tpu_torch.parallel.simulate import run_crash_model_check

    agg = run_crash_model_check(
        args.instances, seed=args.seed, device=args.device,
        n_map=args.n_map, n_reduce=args.n_reduce, n_workers=args.n_workers,
        timeout=args.timeout, horizon=args.horizon,
        exit_prob=args.exit_prob, stall_prob=args.stall_prob)
    print(json.dumps(agg))
    ok = agg["all_finished"] and agg["all_consistent"] and agg["all_safe"]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
