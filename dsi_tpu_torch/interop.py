"""Carry the JAX package's arrays into the port and back, bit for bit.

This system has no weights; what crosses between the two packages is
data: uint8 corpus chunks, uint32 key lanes and output vectors, uint64
packed keys and counts.  torch holds u32/u64 as the same bits in
int32/int64 (its CPU build lacks unsigned shifts), so the unsigned numpy
dtypes are reinterpreted, never converted by value.
"""

from __future__ import annotations

import numpy as np
import torch

_AS_SIGNED = {np.dtype(np.uint32): np.int32, np.dtype(np.uint64): np.int64}


def to_tensor(a) -> torch.Tensor:
    """numpy (or array-like) -> CPU tensor; uint32/uint64 become the same
    bits in int32/int64.  Always a copy: ``torch.from_numpy`` never sees a
    read-only buffer."""
    a = np.array(a)
    signed = _AS_SIGNED.get(a.dtype)
    if signed is not None:
        a = a.view(signed)
    return torch.from_numpy(a)


def to_numpy(t: torch.Tensor, dtype=None) -> np.ndarray:
    """tensor -> numpy on the host; ``dtype=np.uint32``/``np.uint64``
    reinterprets int32/int64 bits as the unsigned type."""
    a = t.detach().cpu().numpy()
    if dtype is not None:
        a = a.view(dtype)
    return a
