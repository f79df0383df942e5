"""Import hygiene of the port: no JAX and nothing of ``dsi_tpu``.

Every ``dsi_tpu_torch`` module and ``chip_smoke.py`` are imported, one
after another, in ONE fresh interpreter; after each import the test reads
``sys.modules`` for ``jax`` and for ``dsi_tpu``/``dsi_tpu.*``.
"""

from __future__ import annotations

import json
import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    import dsi_tpu_torch

    names = ["dsi_tpu_torch"]
    for m in pkgutil.walk_packages(dsi_tpu_torch.__path__, "dsi_tpu_torch."):
        names.append(m.name)
    return sorted(names) + ["chip_smoke"]


MODULES = _port_modules()

_PROBE = """
import importlib, json, sys
out = {}
for name in json.loads(sys.argv[1]):
    importlib.import_module(name)
    out[name] = sorted(m for m in sys.modules
                       if m == "jax" or m.startswith("jax.")
                       or m == "dsi_tpu" or m.startswith("dsi_tpu."))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def loaded():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", _PROBE, json.dumps(MODULES)],
                         capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_every_module_is_listed():
    assert {"dsi_tpu_torch.ops.wordcount", "dsi_tpu_torch.ops.corpus_wc",
            "dsi_tpu_torch.kernels.build", "dsi_tpu_torch.interop",
            "dsi_tpu_torch.parallel.shuffle", "dsi_tpu_torch.parallel.merge",
            "dsi_tpu_torch.parallel.pipeline",
            "dsi_tpu_torch.parallel.stepobj",
            "dsi_tpu_torch.parallel.streaming",
            "dsi_tpu_torch.device.policy", "dsi_tpu_torch.device.table",
            "dsi_tpu_torch.utils.ioread", "dsi_tpu_torch.serve.pack",
            "dsi_tpu_torch.cli.wcstream", "dsi_tpu_torch.ops.meshroute",
            "dsi_tpu_torch.ops.xfer", "dsi_tpu_torch.ops.grepk",
            "dsi_tpu_torch.ops.regexk", "dsi_tpu_torch.ops.altk",
            "dsi_tpu_torch.ops.nfak", "dsi_tpu_torch.apps.grep",
            "dsi_tpu_torch.apps.cuda_grep", "dsi_tpu_torch.device.topk",
            "dsi_tpu_torch.parallel.grepstream",
            "dsi_tpu_torch.cli.grepstream", "dsi_tpu_torch.apps.tfidf",
            "dsi_tpu_torch.device.postings",
            "dsi_tpu_torch.parallel.tfidf", "dsi_tpu_torch.apps.indexer",
            "dsi_tpu_torch.ops.wirecodec", "dsi_tpu_torch.parallel.simulate",
            "dsi_tpu_torch.cli.crashcheck", "dsi_tpu_torch.device.relay",
            "dsi_tpu_torch.mr.shards", "dsi_tpu_torch.plan",
            "dsi_tpu_torch.plan.graph", "dsi_tpu_torch.plan.driver",
            "dsi_tpu_torch.plan.stagehost", "dsi_tpu_torch.cli.planrun",
            "chip_smoke"} <= set(MODULES)


@pytest.mark.parametrize("name", MODULES)
def test_module_imports_no_jax_and_no_dsi_tpu(loaded, name):
    assert loaded[name] == [], f"{name} pulled in {loaded[name]}"
