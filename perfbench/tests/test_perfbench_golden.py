"""The plain reference and the benchmark's weights, bit for bit as they
were before the reference's step loop took an algorithm's hooks (views,
state, optimizer): SimCLR and BYOL at `tiny`'s size on the CPU, in float32,
under the fp8 control and under each fault, each step's loss and the
float64 norm of each leaf's first gradient and final parameters; and the
first 16 hex digits of the SHA-256 of every weight that `inputs.weights`
draws for both configurations.

`golden.json` beside this file holds those readings. It was written by
this file, copied into a checkout of the harness as it was before the
hooks and run there as a script:

    python -m perfbench.tests.test_perfbench_golden perfbench/tests/golden.json

Two CPU threads, as the tests run (`conftest.py`).
"""

import hashlib
import json
import sys
from pathlib import Path

import pytest
import torch

from perfbench import inputs, reference
from perfbench.tests import tiny

GOLDEN = Path(__file__).with_name("golden.json")
SEED = 2**33 + 7
CELLS = ("simclr_r18_b512", "byol_r18_b512")
VARIANTS = {"float32": ("float32", None), "control": ("fp8", None),
            "frozen": ("float32", "frozen"), "frozen_late": ("float32", "frozen_late"),
            "half": ("float32", "half"), "grad2": ("float32", "grad2")}


def _norms(tensors: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def weight_digests(name: str) -> dict:
    cell = tiny.cell(name)
    return {n: hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()[:16]
            for n, t in inputs.weights(cell.specs, SEED, "cpu").items()}


def run_readings(name: str, variant: str) -> dict:
    cell = tiny.cell(name)
    cast, fault = VARIANTS[variant]
    got = reference.run_steps(cell.cfg, inputs.weights(cell.specs, SEED, "cpu"),
                              inputs.images(cell.traffic, SEED, "cpu")["train_images"],
                              int(cell.traffic["check_steps"]), inputs.streams(SEED)["draws"],
                              cell.steps_per_epoch, cast=cast, fault=fault)
    return {"losses": got["losses"], "first_grad": _norms(got["first_grad"]),
            "params": _norms(got["params"])}


def readings() -> dict:
    return {"seed": SEED,
            "weights": {tiny.cell(c).entry["config"]: weight_digests(c) for c in CELLS},
            "runs": {c: {v: run_readings(c, v) for v in VARIANTS} for c in CELLS}}


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


@pytest.mark.parametrize("name", CELLS)
def test_weights_are_the_golden_ones(name, golden):
    assert golden["seed"] == SEED
    assert weight_digests(name) == golden["weights"][tiny.cell(name).entry["config"]]


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("name", CELLS)
def test_reference_reads_the_golden_numbers(name, variant, golden):
    assert run_readings(name, variant) == golden["runs"][name][variant]


if __name__ == "__main__":
    torch.set_num_threads(2)
    Path(sys.argv[1]).write_text(json.dumps(readings(), indent=1) + "\n")
