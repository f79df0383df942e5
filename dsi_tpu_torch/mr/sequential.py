"""Sequential oracle: the semantic definition of correctness.

Copy of ``dsi_tpu/mr/sequential.py:run_sequential`` with the helpers it
takes from ``dsi_tpu/mr/worker.py`` (``group_and_reduce``, ``fnv32a``,
``ihash``).  Reference: ``main/mrsequential.go:25-87`` — read every input,
Map, ONE global sort by key, group runs of equal keys, Reduce, write
``"%v %v\\n"`` lines to a single ``mr-out-0``.  The port's merged, sorted
``mr-out-*`` must byte-compare equal to this.
"""

from __future__ import annotations

import os
from typing import Callable, List, Sequence

from dsi_tpu_torch.mr.types import KeyValue
from dsi_tpu_torch.utils.atomicio import atomic_write

MapFn = Callable[[str, str], List[KeyValue]]
ReduceFn = Callable[[str, List[str]], str]


def fnv32a(data: bytes) -> int:
    """FNV-1a 32-bit hash, exactly Go's hash/fnv.New32a (worker.go:33-37)."""
    h = 0x811C9DC5
    for b in data:
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


def ihash(key: str) -> int:
    """Reference ihash: fnv32a(key) & 0x7fffffff (worker.go:33-37)."""
    return fnv32a(key.encode("utf-8")) & 0x7FFFFFFF


def group_and_reduce(intermediate: List[KeyValue], reducef: ReduceFn,
                     out) -> None:
    """Sort by key, group runs of equal keys, reduce, format "%v %v\\n"
    (worker.go:124-146; identical grouping in main/mrsequential.go:59-84)."""
    intermediate.sort(key=lambda kv: kv.key)
    i = 0
    n = len(intermediate)
    while i < n:
        j = i + 1
        while j < n and intermediate[j].key == intermediate[i].key:
            j += 1
        values = [intermediate[k].value for k in range(i, j)]
        out.write(f"{intermediate[i].key} "
                  f"{reducef(intermediate[i].key, values)}\n")
        i = j


def run_sequential(mapf: MapFn, reducef: ReduceFn, files: Sequence[str],
                   out_path: str = "mr-out-0") -> str:
    intermediate: List[KeyValue] = []
    for filename in files:  # mrsequential.go:39-51
        with open(filename, "rb") as f:
            contents = f.read().decode("utf-8", errors="replace")
        intermediate.extend(mapf(filename, contents))
    with atomic_write(out_path) as out:  # one global sort + group (:59-86)
        group_and_reduce(intermediate, reducef, out)
    return os.path.abspath(out_path)
