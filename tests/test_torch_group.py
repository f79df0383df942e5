"""Kernel C's edge cases against the JAX package, on the CPU.

The cases of ``dsi_tpu_torch/utils/kernel_cases.py group_cases`` (one run
of all rows, all pad rows, no pad row, ``n_unique`` equal to ``u_cap`` and
one above, ``u_cap`` 1, counts above 2^32, k64 1, 2 and 8, pad rows whose
later words differ, heads on tile and warp edges) go through
``dsi_tpu.ops.wordcount.group_sorted`` and the port's ``group_sorted``
(plain version: the tensors lie on the CPU), with and without a payload.
``chip_smoke.py`` runs the same cases at kernel C's own tile on the card.
Every output is an integer: the tolerance is exact.
"""

from __future__ import annotations

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest

from dsi_tpu.ops import wordcount as jw
from dsi_tpu.utils.jaxcompat import enable_x64
from dsi_tpu_torch.interop import to_numpy, to_tensor
from dsi_tpu_torch.kernels import build
from dsi_tpu_torch.ops import wordcount as tw
from dsi_tpu_torch.utils.kernel_cases import group_cases

TILE = 256
CASES = {c[0]: c[1:] for c in group_cases(TILE, 4 * TILE + 37)}


@pytest.mark.parametrize("with_payload", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_group_sorted_matches_jax(name, with_payload):
    keys, counts, u_cap, payload, perm = CASES[name]
    with enable_x64(True):
        _, totals, upos, ovalid, n_unique = jw.group_sorted(
            tuple(jnp.asarray(w) for w in keys), jnp.asarray(counts), u_cap)
        totals, upos, ovalid = (np.asarray(x) for x in (totals, upos, ovalid))
    got = tw.group_sorted(to_tensor(keys), to_tensor(counts), u_cap,
                          to_tensor(payload) if with_payload else None,
                          to_tensor(perm) if with_payload else None)
    keys_u, g_tot, g_upos, g_pay, g_nu = got
    assert int(g_nu) == int(n_unique)
    assert np.array_equal(to_numpy(g_tot), totals.astype(np.int64))
    assert np.array_equal(to_numpy(g_upos), upos)
    assert np.array_equal(to_numpy(keys_u, np.uint64),
                          np.where(ovalid, keys[:, upos], 0))
    want_pay = (np.where(ovalid, payload[perm[upos]], 0) if with_payload
                else np.zeros(u_cap, np.int32))
    assert np.array_equal(to_numpy(g_pay), want_pay)


def test_group_c_interface_is_unchanged():
    """``slice_profile --baseline-csrc`` calls an older C through the first
    two; ``chip_smoke.py`` reads C's tile through the last."""
    p, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    assert build.SIGNATURES["dsi_group"] == (
        c_int, [p, c_int, i64, p, p, p, i64, p, p, p, p, p, p, p])
    assert build.SIGNATURES["dsi_group_scratch_bytes"] == (i64, [i64, i64])
    assert build.SIGNATURES["dsi_group_tile_rows"] == (i64, [])
