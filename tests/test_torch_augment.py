"""The port's augmentation ops against ssv_tpu/data/augment.py, given the
same parameters (random streams cannot match across frameworks, so samplers
take the uniforms JAX drew, or are checked on their statistics)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from ssv_tpu.data import augment as J
from ssv_tpu_torch.data import augment as T
from torch_helpers import t

torch.set_num_threads(2)

rs = np.random.RandomState(0)
IMGS = rs.rand(8, 32, 32, 3).astype(np.float32)
U8 = rs.randint(0, 256, size=(8, 32, 32, 3), dtype=np.uint8)


def _jax_uniforms(key):
    """The unit uniforms sample_rrc_box draws from its four subkeys."""
    k_area, k_ratio, k_i, k_j = jax.random.split(key, 4)
    return (jax.random.uniform(k_area, (10,)), jax.random.uniform(k_ratio, (10,)),
            jax.random.uniform(k_i, ()), jax.random.uniform(k_j, ()))


@pytest.mark.parametrize("in_size,scale", [((32, 32), (0.2, 1.0)),
                                           ((32, 32), (0.08, 1.0)),
                                           ((8, 40), (0.9, 1.0))])
def test_sample_rrc_box_matches_given_jax_uniforms(in_size, scale):
    keys = jax.random.split(jax.random.PRNGKey(3), 256)
    want = jax.vmap(lambda k: jnp.stack(J.sample_rrc_box(k, in_size, scale)))(keys)
    u = jax.vmap(_jax_uniforms)(keys)
    got = T.sample_rrc_box(in_size, scale, *(t(np.asarray(x)) for x in u))
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(), np.asarray(want))


@pytest.mark.parametrize("out_size", [(32, 32), (16, 16), (48, 40)])
def test_crop_resize_matches_scale_and_translate(out_size):
    g = torch.Generator().manual_seed(0)
    u = [torch.rand(8, 10, generator=g), torch.rand(8, 10, generator=g),
         torch.rand(8, generator=g), torch.rand(8, generator=g)]
    box = T.sample_rrc_box((32, 32), (0.08, 1.0), *u)
    got = T.crop_resize(t(IMGS), box, out_size).numpy()
    jbox = jnp.asarray(torch.stack(box, 1).numpy())
    want = jax.vmap(lambda im, b: J.crop_resize(im, tuple(b), out_size))(IMGS, jbox)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("op,lo,hi", [("adjust_brightness", 0.0, 2.0),
                                      ("adjust_contrast", 0.0, 2.0),
                                      ("adjust_saturation", 0.0, 2.0),
                                      ("adjust_hue", -0.5, 0.5)])
def test_adjust_ops(op, lo, hi):
    f = np.random.RandomState(1).uniform(lo, hi, 8).astype(np.float32)
    want = jax.vmap(getattr(J, op))(IMGS, f)
    got = getattr(T, op)(t(IMGS), t(f)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)


def test_hsv_round_trip_ops():
    hsv = T.rgb_to_hsv(t(IMGS))
    np.testing.assert_allclose(hsv.numpy(), np.asarray(J.rgb_to_hsv(IMGS)), atol=1e-6)
    np.testing.assert_allclose(T.hsv_to_rgb(hsv).numpy(),
                               np.asarray(J.hsv_to_rgb(np.asarray(hsv))), atol=1e-6)
    np.testing.assert_allclose(T.rgb_to_grayscale(t(IMGS)).numpy(),
                               np.asarray(J.rgb_to_grayscale(IMGS)), atol=1e-6)


def test_center_crop_normalize_to_float():
    for size in (24, (32, 32), (17, 31)):
        want = jax.vmap(lambda im: J.center_crop(im, size))(IMGS)
        np.testing.assert_array_equal(T.center_crop(t(IMGS), size).numpy(), np.asarray(want))
    mean, std = [0.4914, 0.4822, 0.4465], [0.247, 0.2435, 0.2616]
    np.testing.assert_allclose(T.normalize(t(IMGS), mean, std).numpy(),
                               np.asarray(J.normalize(IMGS, mean, std)), atol=1e-6)
    np.testing.assert_array_equal(T.to_float(t(U8)).numpy(), np.asarray(J.to_float(U8)))


def test_random_flip():
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    g = torch.Generator().manual_seed(0)
    for p in (1.0, 0.0):
        want = jax.vmap(lambda k, im: J.random_flip(k, im, p))(keys, IMGS)
        np.testing.assert_allclose(T.random_flip(g, t(IMGS), p).numpy(),
                                   np.asarray(want), atol=1e-6)
    got = T.random_flip(g, t(IMGS)).numpy()
    flipped = [np.array_equal(got[i], IMGS[i, :, ::-1]) for i in range(8)]
    kept = [np.array_equal(got[i], IMGS[i]) for i in range(8)]
    assert all(a or b for a, b in zip(flipped, kept))


def test_test_transform_matches_jax():
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    want = jax.vmap(J.build_transform(helpers.test_t()))(keys, U8)
    got = T.build_transform(helpers.test_t())(torch.Generator(), t(U8))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_train_batch_transform_runs_fused_pair():
    cfg = helpers.train_t()
    cfg["random_gray"] = {"p": 1.0}
    del cfg["normalize"]
    out = T.build_batch_transform(cfg)(torch.Generator().manual_seed(0), t(U8))
    assert out.shape == (8, 32, 32, 3) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    # gray gate always on: channels equal, and RRC/flip keep them equal
    torch.testing.assert_close(out[..., 0], out[..., 1], atol=1e-6, rtol=0)
    torch.testing.assert_close(out[..., 1], out[..., 2], atol=1e-6, rtol=0)


def test_unported_ops_raise():
    """No op is left unported: TRANSFORM_OPS has every key of the JAX
    package's, with the same (needs a generator/key, shape-preserving)
    flags, and each builds; an unknown name still raises."""
    assert {k: v[1:] for k, v in T.TRANSFORM_OPS.items()} == \
        {k: v[1:] for k, v in J.TRANSFORM_OPS.items()}
    assert not hasattr(T, "NOT_PORTED")
    cfg = copy.deepcopy(helpers.test_t())
    cfg["gaussian_blur"] = None
    assert T.build_transform(cfg)(torch.Generator(), t(U8)).shape == (8, 32, 32, 3)
    with pytest.raises(ValueError):
        T.build_transform({"no_such_op": None})
