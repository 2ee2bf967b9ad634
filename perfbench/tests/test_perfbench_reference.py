"""The plain reference against the port's own step, on the CPU at a small
size, for each configuration, with the port in float32.

Both sides then compute the same float32 mathematics, but not to the last
bit: where a max-pool window's maximum is tied (flat regions of clamped,
upsampled images) or nearly so, the two kernels may send its gradient to
different inputs, and the gradient of the stem and the change that follows
part by up to a few percent; a BN scale near 1 stores a change of 1e-6 in
steps of 6e-8. The bounds below take that; each is well under the cell's
limit for the bf16 program."""

import pytest

from perfbench.tests import tiny

AGREE = {"loss": 5e-4, "grad": 0.05, "change": 0.1}


@pytest.mark.parametrize("cell", ["simclr_r18_b512", "byol_r18_b512"])
def test_reference_agrees_with_the_port(cell):
    nums = {}
    res = tiny.measure(cell, detail=nums)
    for number, limit in AGREE.items():
        assert nums[number][0] <= limit, (number, nums[number])
    assert res["correct"] is True
