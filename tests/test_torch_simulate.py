"""The port's crash model checker against the JAX package, on the CPU.

``dsi_tpu_torch/parallel/simulate.py`` writes JAX's threefry-2x32 out as
torch functions, so the port is held to the reference instance by
instance: its ``prng_key``, ``split``, ``fold_in`` and ``uniform`` must
equal ``jax.random``'s (under ``jax.threefry_partitionable(True)``, set
only inside the tests), and ``simulate_batch`` (the plain version here)
must equal ``jax.vmap(simulate_job)`` over ``split(PRNGKey(seed), n)`` in
all seven outputs of every instance, in six fault configurations.
``run_crash_model_check`` must equal the reference's dict key for key,
instance ``i`` must not depend on the run's size, and the ``crashcheck``
command must print the reference's line.  Tolerance: exact.
"""

from __future__ import annotations

import functools
import json

import jax
import numpy as np
import pytest
import torch

from dsi_tpu.cli import crashcheck as jcli
from dsi_tpu.parallel import simulate as jsim
from dsi_tpu_torch.cli import crashcheck as tcli
from dsi_tpu_torch.ops import wordcount as tw
from dsi_tpu_torch.parallel import simulate as tsim

N = 64
SEED = 3
CONFIGS = {
    "defaults": dict(horizon=800),
    "no_faults": dict(exit_prob=0.0, stall_prob=0.0, horizon=200),
    "stalls": dict(exit_prob=0.0, stall_prob=0.5, timeout=5, horizon=800),
    "one_worker": dict(n_workers=1, horizon=800),
    "five_workers": dict(n_workers=5, horizon=800),
    "short_horizon": dict(n_map=3, n_reduce=2, horizon=20),
}


def _key(key) -> tuple:
    return tuple(int(v) for v in np.asarray(key).reshape(-1))


@pytest.mark.parametrize("seed", [0, 1, 42, 123456789, -1])
def test_threefry_helpers_match_jax(seed):
    with jax.threefry_partitionable(True):
        jkey = jax.random.PRNGKey(seed)
        tkey = tsim.prng_key(seed)
        assert _key(tkey) == _key(jkey)
        jkeys = np.asarray(jax.random.split(jkey, 6))
        tkeys = tsim.split(tkey, 6)
        assert np.array_equal(tkeys.numpy(), jkeys.astype(np.int64))
        assert np.array_equal(tsim.split(tkey, 2, first=4).numpy(),
                              jkeys[4:].astype(np.int64))
        for i, k in enumerate(jkeys):
            for d in (0, 1, 7, 800, 2 ** 31 - 1):
                assert _key(tsim.fold_in(tkeys[i], d)) == \
                    _key(jax.random.fold_in(k, d))
            u = tsim.uniform(tkeys[i])
            assert u.dtype == torch.float32
            assert u.item() == float(jax.random.uniform(k))
        # Batched forms: a [n, 2] key tensor against one data tensor.
        data = torch.arange(6, dtype=torch.int64) * 97
        want = np.stack([np.asarray(jax.random.fold_in(k, int(d)))
                         for k, d in zip(jkeys, data)]).astype(np.int64)
        assert np.array_equal(tsim.fold_in(tkeys, data).numpy(), want)


def test_threefry_keys_outside_int32_raise():
    with pytest.raises(ValueError):
        tsim.prng_key(1 << 31)


@functools.lru_cache(maxsize=None)
def _reference(name: str, n: int = N):
    """jax.vmap(simulate_job) over split(PRNGKey(SEED), n), as numpy."""
    with jax.threefry_partitionable(True):
        keys = jax.random.split(jax.random.PRNGKey(SEED), n)
        out = jax.vmap(lambda k: jsim.simulate_job(k, **CONFIGS[name]))(keys)
        return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_simulate_batch_matches_reference_per_instance(name):
    want = _reference(name)
    tw.reset_launches()
    got = tsim.simulate_batch(SEED, N, device="cpu", **CONFIGS[name])
    assert all(v == 0 for v in tw.launch_counts().values())
    assert set(got) == set(want) == set(tsim.OUTPUTS)
    for k in tsim.OUTPUTS:
        assert got[k].shape == (N,)
        assert got[k].numpy().dtype == want[k].dtype, k
        assert np.array_equal(got[k].numpy(), want[k]), k
    if name == "short_horizon":  # the horizon cut some instances short
        assert not want["finished"].all() and want["finished"].any()
        assert (want["ticks"][~want["finished"]] == 20).all()
    if name == "stalls":
        assert want["duplicates"].sum() > 0
        assert want["buggy_would_break_barrier"].any()


def test_simulate_job_matches_reference():
    cfg = CONFIGS["defaults"]
    with jax.threefry_partitionable(True):
        jkey = jax.random.split(jax.random.PRNGKey(SEED), N)[5]
        want = jax.device_get(jsim.simulate_job(jkey, **cfg))
    got = tsim.simulate_job(tsim.split(tsim.prng_key(SEED), N)[5], **cfg)
    for k in tsim.OUTPUTS:
        assert got[k].item() == want[k].item(), k


@pytest.mark.parametrize("name", ["defaults", "stalls"])
def test_run_crash_model_check_matches_reference(name):
    with jax.threefry_partitionable(True):
        want = jsim.run_crash_model_check(N, seed=SEED, **CONFIGS[name])
    got = tsim.run_crash_model_check(N, seed=SEED, device="cpu",
                                     **CONFIGS[name])
    assert list(got) == list(want)
    for k in want:
        assert type(got[k]) is type(want[k]), k
        assert got[k] == want[k], k


def test_instance_does_not_depend_on_run_size():
    cfg = CONFIGS["defaults"]
    small = tsim.simulate_batch(SEED, 16, device="cpu", **cfg)
    large = tsim.simulate_batch(SEED, 64, device="cpu", **cfg)
    tail = tsim.simulate_batch(SEED, 16, first=48, device="cpu", **cfg)
    for k in tsim.OUTPUTS:
        assert torch.equal(small[k], large[k][:16]), k
        assert torch.equal(tail[k], large[k][48:]), k


@pytest.mark.parametrize("name", ["no_faults", "defaults"])
def test_plain_work_counts(name):
    """The work counts that kernel O's bound is built from: without faults
    every task is taken and reported once; with them, a tick key is drawn
    at most once a tick and only where a task is taken, and every report
    answers an assignment.  Counting leaves the outputs as they were."""
    cfg = CONFIGS[name]
    work: dict = {}
    got = tsim.simulate_batch_plain(SEED, N, device="cpu", work=work, **cfg)
    want = tsim.simulate_batch(SEED, N, device="cpu", **cfg)
    for k in tsim.OUTPUTS:
        assert torch.equal(got[k], want[k]), k
    assert set(work) == set(tsim.WORK)
    ticks = int(got["ticks"].sum())
    if name == "no_faults":
        tasks = N * (8 + 10)
        assert work["assignments"] == work["reports"] == tasks
    else:
        assert work["reports"] < work["assignments"]
    assert 0 < work["keyed_ticks"] <= min(ticks, work["assignments"])


def test_simulate_batch_checks_device_and_sizes():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tsim.simulate_batch(0, 4)
    with pytest.raises(ValueError, match="bad sizes"):
        tsim.simulate_batch(0, 4, n_map=0, device="cpu")
    empty = tsim.simulate_batch(0, 0, device="cpu")
    assert all(v.shape == (0,) for v in empty.values())


def test_crashcheck_cli_prints_the_reference_line(capsys):
    args = ["-n", "32", "--seed", str(SEED), "--horizon", "800"]
    with jax.threefry_partitionable(True):
        rc_want = jcli.main(args + ["--platform", "default"])
    want = capsys.readouterr().out.strip().splitlines()[-1]
    rc = tcli.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want and rc == rc_want == 0
    assert json.loads(got)["instances"] == 32
