"""Build and bind the port's CUDA kernels (``dsi_tpu_torch/csrc/*.cu``).

Each ``.cu`` source is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects link into one shared library with a
plain C interface, loaded with ``ctypes``.  Nothing includes PyTorch's
headers, so a cold build takes seconds.  The library goes to
``build/dsi_tpu_torch/`` under the repository root, named by a hash of the
sources and flags, so an edited source never loads a stale library.  The
build runs at first use (``library()``) and raises on any failure.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dsi_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_F32 = ctypes.c_float
# name -> (restype, argtypes) of every C entry point in csrc/.
SIGNATURES = {
    "dsi_tokenize_scratch_bytes": (_I64, [_I64]),
    "dsi_tokenize": (_INT, [_P, _I64, _INT, _I64, _P, _P, _P, _P, _P, _P]),
    "dsi_tokenize_tile_bytes": (_I64, []),
    "dsi_radix_sort_scratch_bytes": (_I64, [_I64]),
    "dsi_radix_sort": (_INT, [_P, _INT, _I64, _P, _P, _P, _P]),
    "dsi_radix_sort_ex": (_INT, [_P, _INT, _I64, _P, _P, _P, _P, _P, _INT]),
    "dsi_radix_sort_passes_offset": (_I64, [_I64]),
    "dsi_radix_sort_small_max": (_I64, []),
    "dsi_group_scratch_bytes": (_I64, [_I64, _I64]),
    "dsi_group": (_INT, [_P, _INT, _I64, _P, _P, _P, _I64, _P, _P, _P, _P,
                         _P, _P, _P]),
    "dsi_group_tile_rows": (_I64, []),
    "dsi_fnv": (_INT, [_P, _INT, _I64, _INT, _P, _INT, _P, _P, _P, _INT,
                       _INT, _INT, _P, _P, _P]),
    "dsi_route_scratch_bytes": (_I64, [_INT, _I64, _INT]),
    "dsi_route": (_INT, [_P, _P, _INT, _I64, _INT, _INT, _P, _P, _P]),
    "dsi_route_tile_rows": (_I64, [_INT]),
    "dsi_route_totals_offset": (_I64, [_INT, _I64, _INT]),
    "dsi_hash_group_scratch_bytes": (_I64, [_INT, _I64, _I64]),
    "dsi_hash_bucket": (_INT, [_P, _INT, _I64, _P, _P, _P, _P, _I64, _I64,
                               _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P]),
    "dsi_hash_assemble": (_INT, [_INT, _I64, _I64, _I64, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _P, _P, _P, _P, _P]),
    "dsi_pack6": (_INT, [_P, _I64, _P, _P, _P]),
    "dsi_grep_scratch_bytes": (_I64, [_I64]),
    "dsi_grep_bytes": (_I64, [_I64, _I64]),
    "dsi_grep_tile_bytes": (_I64, []),
    "dsi_grep": (_INT, [_P, _I64, _P, _P, _P, _I64, _P, _P]),
    "dsi_line_flags_prezeroed": (_INT, [_P, _I64, _P, _I64, _P, _P, _P, _P]),
    "dsi_nfa_scratch_bytes": (_I64, [_I64, _INT]),
    "dsi_nfa": (_INT, [_P, _I64, _P, _INT, _P, _I64, _P, _P, _P, _INT, _P]),
    "dsi_nfa_group_bytes": (_I64, []),
    "dsi_grep_step_scratch_bytes": (_I64, [_INT, _I64, _I64, _INT, _INT]),
    "dsi_grep_step": (_INT, [_P, _INT, _I64, _P, _INT, _P, _P, _I64, _INT,
                             _INT, _P, _P, _P, _P, _P, _P, _P]),
    "dsi_grep_step_tile_bytes": (_I64, []),
    "dsi_grep_step_line_tile": (_I64, []),
    "dsi_relay_pack": (_INT, [_P, _INT, _I64, _P, _P, _P]),
    "dsi_compact_scratch_bytes": (_I64, [_INT, _I64, _INT]),
    "dsi_compact_tile_rows": (_I64, [_INT, _I64, _INT]),
    "dsi_compact": (_INT, [_P, _INT, _I64, _INT, _INT, _P, _P, _P, _P]),
    "dsi_postings_append": (_INT, [_P, _INT, _I64, _INT, _P, _P, _P, _I64,
                                   _P, _INT, _P, _P, _P, _P]),
    "dsi_postings_append_received_scratch_bytes": (_I64, [_INT, _I64]),
    "dsi_postings_append_received": (_INT, [_P, _INT, _I64, _INT, _P, _P,
                                            _P, _I64, _P, _P, _P, _P, _P,
                                            _P]),
    "dsi_wire_decode_scratch_bytes": (_I64, [_INT, _I64]),
    "dsi_wire_decode": (_INT, [_P, _INT, _I64, _I64, _I64, _INT, _P, _P, _P]),
    "dsi_wire_decode_tile_bytes": (_I64, []),
    "dsi_crash_sim_scratch_bytes": (_I64, [_I64, _INT, _INT, _INT]),
    "dsi_crash_sim": (_INT, [_I64, _I64, _I64, _I64, _INT, _INT, _INT, _INT,
                             _INT, _F32, _F32, _P, _P, _P]),
}

_lib: Optional[ctypes.CDLL] = None
# ptxas register/shared-memory report of the last build, for chip_smoke.py.
build_log = ""


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return nvcc


def _digest(csrc: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(csrc.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(csrc: Path = CSRC, out_dir: Path = BUILD_DIR) -> Path:
    """Compile every ``.cu`` of ``csrc`` in parallel and link the library
    into ``out_dir``; return its path.  Raises RuntimeError with the
    compiler's output on failure."""
    global build_log
    lib_path = out_dir / f"libdsi_kernels-{_digest(csrc)}.so"
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sorted(csrc.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib),
             *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)  # atomic: a reader never sees half
    return lib_path


def load(path: Path, names=None) -> ctypes.CDLL:
    """Load a built kernel library and declare its C entry points: all of
    them, or only ``names`` (a library built from another version of
    ``csrc/`` may lack the newer ones)."""
    lib = ctypes.CDLL(str(path))
    for name in SIGNATURES if names is None else names:
        restype, argtypes = SIGNATURES[name]
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call in this process."""
    global _lib
    if _lib is None:
        _lib = load(build())
    return _lib
