"""The photometric kernel (`ops/photometric.py`, `csrc/photometric.cu`) on a
CUDA card, against its plain PyTorch version; skips without a card. Its
CPU tests, which hold the plain version against the JAX package's kernel,
are in `test_torch_photometric.py`; this file imports no JAX, so it runs
on a card machine that has none:

    python -m pytest tests/test_torch_photometric_card.py -m card --noconftest
"""

import pytest
import torch

from ssv_tpu_torch.ops.photometric import fused_photometric, photometric_reference
from ssv_tpu_torch.tools.measure import photometric_inputs
from torch_helpers import card  # noqa: F401 (a fixture)

TOL = 1e-5   # float32, the kernel against the plain version, max abs diff


# the main path's shape, the most pixels the registers hold (16 a thread),
# an odd shape, and one past 64x64 (a pass per op)
@pytest.mark.card
@pytest.mark.parametrize("B,H,W", [(512, 32, 32), (64, 64, 64), (5, 7, 9), (3, 70, 65)])
def test_card_kernel_holds_to_the_plain_version(B, H, W, card):
    """Random parameters and the edge cases `photometric_inputs` plants (the
    identity, hue at +-0.5, the gray gate, gray and black images): a finite
    output within TOL of `photometric_reference`, and the first `n` images,
    whose factors are the identity, bit for bit unchanged."""
    g = torch.Generator(device=card).manual_seed(0)
    images, order, params, n = photometric_inputs(B, H, W, g)
    got = fused_photometric(images, order, params)
    want = photometric_reference(images, order, params)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    print(f"photometric B={B} {H}x{W}: max |kernel - plain| = {err:.3e}")
    assert err <= TOL
    assert torch.equal(got[:n], images[:n])
