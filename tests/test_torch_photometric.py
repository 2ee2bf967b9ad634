"""The port's photometric op against the JAX Pallas kernel.

`photometric_reference` (the plain version the CUDA kernel is held against
on the card) must agree with `fused_photometric(..., interpret=True)` on the
same (images, order, params) to 1e-5, the tolerance of
tests/test_pallas_photometric.py; the sampler is checked on its statistics.
"""

import numpy as np
import pytest
import torch

from ssv_tpu.ops.pallas.photometric import fused_photometric as jax_fused
from ssv_tpu_torch.ops.photometric import (fused_photometric,
                                           photometric_reference,
                                           sample_photometric_params)
from torch_helpers import t

torch.set_num_threads(2)

ATOL = 1e-5
JITTER = {"brightness": 0.4, "contrast": 0.4, "saturation": 0.4, "hue": 0.1}


def _random_params(rs, B):
    return np.stack([rs.uniform(0.6, 1.4, B), rs.uniform(0.6, 1.4, B),
                     rs.uniform(0.6, 1.4, B), rs.uniform(-0.1, 0.1, B),
                     (rs.rand(B) < 0.2)], axis=1).astype(np.float32)


def _case(name):
    rs = np.random.RandomState(CASES.index(name))
    B, H, W = (5, 7, 9) if name == "odd_5x7x9" else (16, 32, 32)
    images = rs.rand(B, H, W, 3).astype(np.float32)
    order = np.stack([rs.permutation(4) for _ in range(B)]).astype(np.int32)
    params = _random_params(rs, B)
    if name == "gate_off":
        params[:] = [1.0, 1.0, 1.0, 0.0, 0.0]
    elif name == "hue_half":
        params[:, 3] = np.where(np.arange(B) % 2 == 0, 0.5, -0.5)
    elif name == "gray_gate":
        params[:, 4] = 1.0
    elif name == "equal_channels":
        images = np.repeat(images[..., :1], 3, axis=-1)
    elif name == "zeros":
        images = np.zeros_like(images)
    return images, order, params


CASES = ["random_16x32x32", "odd_5x7x9", "gate_off", "hue_half", "gray_gate",
         "equal_channels", "zeros"]


@pytest.mark.parametrize("name", CASES)
def test_reference_matches_jax_kernel(name):
    images, order, params = _case(name)
    want = np.asarray(jax_fused(images, order, params, interpret=True))
    got = photometric_reference(t(images), t(order), t(params)).numpy()
    assert got.shape == images.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if name == "gate_off":
        # identity factors return the input bit for bit
        np.testing.assert_array_equal(got, images)


def test_cpu_tensor_takes_plain_version_without_launch():
    images, order, params = _case("random_16x32x32")
    before = fused_photometric.launches
    got = fused_photometric(t(images), t(order), t(params))
    want = photometric_reference(t(images), t(order), t(params))
    assert torch.equal(got, want)
    assert fused_photometric.launches == before


def test_sampler_statistics():
    n = 20000
    g = torch.Generator().manual_seed(0)
    order, params = sample_photometric_params(n, JITTER, 0.2, 0.8, g, "cpu")
    assert order.dtype == torch.int32 and order.shape == (n, 4)
    assert params.dtype == torch.float32 and params.shape == (n, 5)
    # every row is a permutation of the four ops
    assert torch.equal(order.sort(dim=1).values,
                       torch.arange(4, dtype=torch.int32).expand(n, 4))
    fb, fc, fs, fh, gray = params.unbind(1)
    applied = fh != 0
    assert abs(applied.float().mean().item() - 0.8) < 0.015
    assert abs(gray.mean().item() - 0.2) < 0.015
    assert set(gray.unique().tolist()) <= {0.0, 1.0}
    for f in (fb, fc, fs):
        assert torch.all(f[~applied] == 1.0)
        on = f[applied]
        assert on.min() >= 0.6 and on.max() <= 1.4
        assert on.min() < 0.61 and on.max() > 1.39
    on = fh[applied]
    assert on.min() >= -0.1 and on.max() <= 0.1
    assert on.min() < -0.099 and on.max() > 0.099
    # each op comes first about a quarter of the time
    first = torch.bincount(order[:, 0].long(), minlength=4).float() / n
    assert torch.all((first - 0.25).abs() < 0.02)


def test_sampler_without_gate_always_applies():
    g = torch.Generator().manual_seed(1)
    _, params = sample_photometric_params(1000, {"brightness": 0.2}, 0.0, None, g, "cpu")
    assert torch.all(params[:, 0] != 1.0)
    assert torch.all(params[:, 1:] == torch.tensor([1.0, 1.0, 0.0, 0.0]))
