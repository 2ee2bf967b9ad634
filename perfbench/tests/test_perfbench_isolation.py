"""What a run loads and prints: no JAX and no JAX package anywhere, nothing
of the program in the reference, the result line's keys, and no result
without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
ENV = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"}


def _python(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package():
    got = _python(
        "import json, sys\n"
        "from perfbench.tests import tiny\n"
        "from perfbench.harness import forbidden_modules\n"
        "tiny.measure('simclr_r18_b512', traced=True)\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(json.dumps({'bad': forbidden_modules(), 'port': 'ssv_tpu_torch' in tops}))\n")
    assert got == {"bad": [], "port": True}


def test_the_reference_loads_nothing_of_the_program():
    got = _python(
        "import json, sys\n"
        "from perfbench.calibrate import planted\n"
        "from perfbench.tests import tiny\n"
        "planted(tiny.cell('byol_r18_b512'), 3, 'cpu')\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(json.dumps(sorted(tops & {'jax', 'jaxlib', 'flax', 'ssv_tpu', 'ssv_tpu_torch'})))\n")
    assert got == []


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    res = tiny.measure("byol_r18_b512", traced=traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res) == keys + (["breakdown"] if traced else []) + ["checks"]
    assert isinstance(res["correct"], bool) and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    limits = tiny.cell("byol_r18_b512").limits
    assert list(res["checks"]) == [k for k in ("loss", "grad", "change") if k in limits]
    for check in res["checks"].values():
        assert list(check) == ["value", "limit"]
    if traced:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(res["device"])
    else:
        # no CUDA events on the CPU, so no step intervals: no step_ms_p95
        assert set(res["metrics"]) == {"train_img_per_s", "setup_s"}


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "simclr_r18_b512",
                          "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
