"""The control, the reference with every tensor the recipe keeps in bf16
rounded to fp8 (the precision below), put in the program's place, fails
the cell's limits: on the CPU at a small size, and on the card at the
cell's own size on three seeds. So does each fault planted in the
reference, the state left unchanged from the fourth step on among them."""

import pytest

from perfbench import calibrate, compare, harness
from perfbench.tests import tiny

CELLS = ["simclr_r18_b512", "byol_r18_b512"]


def _fails(cell, readings) -> bool:
    return any(readings[k] > cell.limits[k]["limit"] for k in compare.NUMBERS
               if k in cell.limits)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_a_small_size(name):
    cell = tiny.cell(name)
    got = calibrate.planted(cell, 11, "cpu")
    assert _fails(cell, got["control"]), got["control"]
    for fault in ("frozen", "frozen_late", "half", "grad2"):
        assert _fails(cell, got[fault]), (fault, got[fault])


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, card):
    cell = harness.Cell(name)
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        got = calibrate.planted(cell, seed, card)
        assert _fails(cell, got["control"]), (seed, got["control"])
