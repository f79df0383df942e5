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


def nfa_table_to_bits(table, v0):
    """The JAX package's NFA table (``ops/nfak.py _build_table``: [256, S,
    S] float32 and [S] float32, numpy) in kernel I's bit-set form: (bits
    [256, S] uint64, v0bits uint64)."""
    from dsi_tpu_torch.ops.nfak import nfa_table_bits

    bits, v0bits = nfa_table_bits(torch.from_numpy(np.asarray(table)),
                                  torch.from_numpy(np.asarray(v0)))
    return to_numpy(bits, np.uint64), to_numpy(v0bits, np.uint64)[0]


def nfa_table_from_bits(bits, v0bits):
    """Inverse of :func:`nfa_table_to_bits`: the [256, S, S] and [S]
    float32 0/1 arrays back from the bit sets."""
    bits = np.asarray(bits, dtype=np.uint64)
    s = bits.shape[1]
    shifts = np.arange(s, dtype=np.uint64)
    table = ((bits[:, :, None] >> shifts) & np.uint64(1)).astype(np.float32)
    v0 = ((np.uint64(v0bits) >> shifts) & np.uint64(1)).astype(np.float32)
    return table, v0
