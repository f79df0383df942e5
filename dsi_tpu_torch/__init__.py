"""dsi_tpu_torch — the PyTorch/CUDA port of ``dsi_tpu``.

A second package beside ``dsi_tpu`` (the JAX reference, which stays as it
is).  Plain tensor code is PyTorch; every device program on the ported path
is a CUDA C++ kernel written by hand for Hopper (``csrc/``), built at first
use by ``kernels/build.py``.

Rules the package keeps:

* it imports ``torch`` and numpy, never ``jax``, and nothing of
  ``dsi_tpu`` — it carries its own copies of what it needs;
* entry points take ``device=None``, which means ``cuda``, and raise when
  CUDA is absent; they run on the CPU only when the caller passes
  ``device="cpu"``;
* a kernel wrapper given a CUDA tensor launches its kernel or raises; a
  CPU tensor runs the plain PyTorch version kept beside it.

Package layout (each module keeps its ``dsi_tpu`` counterpart's name):
  mr/       KeyValue and the sequential oracle
  apps/     the word-count and grep apps (host Map, Reduce) and
            ``cuda_grep.cuda_map``, grep's device tier walk
  ops/      word count per split and over the whole corpus; grep's tiers
  parallel/ the streaming word count and the streaming grep
  device/   the device-resident table, top-k and histogram services
  cli/      ``wcstream`` and ``grepstream``
  kernels/  the CUDA build and the ctypes binding
  csrc/     the kernels' sources
  utils/    corpus generation, atomic file commit
  interop   numpy <-> tensor conversion for the JAX package's arrays
"""

__version__ = "0.1.0"

from dsi_tpu_torch.mr.types import KeyValue  # noqa: F401
