"""The port's remaining augmentation ops (Gaussian blur, random crop, resize,
cutout, the affine warp and RandAugment with each of its 14 branches)
against ssv_tpu/data/augment.py, given the JAX package's draws: each random
op of the port applies given draws (`random_crop_at`, `gaussian_blur_sigma`,
`cutout_at`, `rand_augment_apply`), and the test hands it what JAX's key
schedule draws. Batches are non-square (24x40), so rows and columns cannot
swap unseen."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssv_tpu.data import augment as J
from ssv_tpu_torch.data import augment as T
from torch_helpers import t

torch.set_num_threads(2)

B, H, W = 6, 24, 40
rs = np.random.RandomState(7)
IMGS = rs.rand(B, H, W, 3).astype(np.float32)
IMGS[0] = 0.25                       # a constant image: equalize's step 0
IMGS[1] = np.round(IMGS[1] * 255) / 255   # on the u8 grid
KEYS = jax.random.split(jax.random.PRNGKey(11), B)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("size,padding", [(24, 4), ((16, 28), 0), ((20, 40), 2)])
def test_random_crop_given_jax_offsets(size, padding):
    hw = (size, size) if isinstance(size, int) else size

    def offsets(k):
        ki, kj = jax.random.split(k)
        return (jax.random.randint(ki, (), 0, H + 2 * padding - hw[0] + 1),
                jax.random.randint(kj, (), 0, W + 2 * padding - hw[1] + 1))

    i, j = jax.vmap(offsets)(KEYS)
    want = jax.vmap(lambda k, im: J.random_crop(k, im, size, padding))(KEYS, IMGS)
    got = T.random_crop_at(t(IMGS), t(np.asarray(i)), t(np.asarray(j)), size, padding)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size,method", [(16, "linear"), ((12, 20), "linear"),
                                         ((40, 64), "linear"), ((16, 28), "cubic"),
                                         ((48, 56), "cubic")])
def test_resize_up_and_down(size, method):
    want = jax.vmap(lambda im: J.resize(im, size, method))(IMGS)
    _close(T.resize(t(IMGS), size, method), want)


def test_resize_other_methods_raise():
    with pytest.raises(ValueError, match="linear.*cubic"):
        T.resize(t(IMGS), 16, "nearest")


@pytest.mark.parametrize("sigma", [0.1, 2.0])
def test_gaussian_blur_at_fixed_sigma(sigma):
    want = jax.vmap(lambda im: J._gaussian_blur_sigma(im, jnp.float32(sigma)))(IMGS)
    _close(T.gaussian_blur_sigma(t(IMGS), torch.full((B,), sigma)), want)


def test_gaussian_blur_given_jax_sigmas():
    sig = jax.vmap(lambda k: jax.random.uniform(k, (), minval=0.1, maxval=2.0))(KEYS)
    want = jax.vmap(lambda k, im: J.gaussian_blur(k, im))(KEYS, IMGS)
    _close(T.gaussian_blur_sigma(t(IMGS), t(np.asarray(sig))), want)


@pytest.mark.parametrize("n_cuts,max_len", [(0, 1), (1, 16), (3, 12)])
def test_cutout_given_jax_draws(n_cuts, max_len):
    def draws(k):
        k_len, k_xy = jax.random.split(k)
        return (jax.random.randint(k_len, (), 1, max_len + 1),
                jax.random.randint(k_xy, (max(n_cuts, 1), 2), 0, max(W, H) + 1))

    cut_len, xs = jax.vmap(draws)(KEYS)
    want = jax.vmap(lambda k, im: J.cutout(k, im, n_cuts, max_len))(KEYS, IMGS)
    got = T.cutout_at(t(IMGS), t(np.asarray(cut_len)), t(np.asarray(xs)), n_cuts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if n_cuts == 0:
        np.testing.assert_array_equal(got.numpy(), IMGS)
    else:
        assert (got.numpy() == 0).all(axis=-1).any()


def _branch_values(c, seed):
    """Magnitudes of branch c as rand_augment draws them, one per image."""
    _, lo, hi, signed, _ = J._RANDAUG_OPS[c]
    r = np.random.RandomState(seed)
    u = r.rand(B).astype(np.float32)
    sign = np.where(r.rand(B) > 0.5, -1.0, 1.0).astype(np.float32)
    v = lo + (hi - lo) * jnp.asarray(u)
    return np.asarray(v * sign if signed else v)


EXACT = ("identity", "equalize", "solarize", "posterize")


@pytest.mark.parametrize("c", range(14), ids=[op[0] for op in J._RANDAUG_OPS])
def test_rand_augment_branch(c):
    """Each of RandAugment's 14 ops at magnitudes from its range (the
    reference's quirks kept: color, contrast, brightness and sharpness at 1
    are identities, solarize's threshold is 1, posterize keeps 1 bit)."""
    name, fn = J._RANDAUG_OPS[c][0], J._RANDAUG_OPS[c][4]
    assert T.RANDAUG_OPS[c][:4] == J._RANDAUG_OPS[c][:4]
    v = _branch_values(c, c)
    want = jax.vmap(fn)(IMGS, jnp.asarray(v))
    got = T.RANDAUG_OPS[c][4](t(IMGS), t(v))
    if name in EXACT:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want)


@pytest.mark.parametrize("op,values", [("rotate", [-30.0, -7.5, 0.0, 12.25, 30.0, 90.0]),
                                       ("shear_x", [-0.3, -0.1, 0.0, 0.05, 0.1, 0.5]),
                                       ("shear_y", [-0.3, -0.1, 0.0, 0.05, 0.1, 0.5]),
                                       ("translate_x", [-0.5, -0.1, 0.0, 0.03, 0.1, 0.25]),
                                       ("translate_y", [-0.5, -0.1, 0.0, 0.03, 0.1, 0.25]),
                                       ("solarize", [0.0, 1.0, 64.0, 128.0, 200.0, 256.0]),
                                       ("posterize", [1, 2, 4, 6, 8, 3]),
                                       ("sharpness", [0.0, 0.5, 1.0, 1.5, 2.0, 0.1])])
def test_rand_augment_ops_off_the_reference_ranges(op, values):
    """The same ops at magnitudes RandAugment never draws (posterize and
    solarize above 1, sharpness away from 1, wide angles and shifts)."""
    v = np.asarray(values, np.float32)
    want = jax.vmap(getattr(J, op))(IMGS, jnp.asarray(v))
    got = getattr(T, op)(t(IMGS), t(v))
    if op in EXACT:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want)


def test_affine_warp_given_matrices():
    m = np.random.RandomState(3).uniform(-1, 1, (B, 6)).astype(np.float32)
    m[:, [0, 4]] += 1.0
    m[:, [2, 5]] *= 8.0
    want = jax.vmap(lambda im, mm: J.affine_warp(im, tuple(mm)))(IMGS, jnp.asarray(m))
    _close(T.affine_warp(t(IMGS), t(m)), want)


@pytest.mark.parametrize("n_aug", [1, 4])
def test_rand_augment_given_jax_draws(n_aug):
    def draws(k):
        out = []
        for _ in range(n_aug):
            k, k_choice, k_v, k_sign = jax.random.split(k, 4)
            out.append((jax.random.randint(k_choice, (), 0, 14), jax.random.uniform(k_v, ()),
                        jnp.where(jax.random.uniform(k_sign, ()) > 0.5, -1.0, 1.0)))
        return [jnp.stack(x) for x in zip(*out)]

    keys = jax.random.split(jax.random.PRNGKey(5), 24)
    imgs = np.concatenate([IMGS] * 4)
    choice, u, sign = (t(np.asarray(x).T) for x in jax.vmap(draws)(keys))
    assert len(set(choice.flatten().tolist())) >= 10     # most branches taken
    want = jax.vmap(lambda k, im: J.rand_augment(k, im, n_aug))(keys, imgs)
    _close(T.rand_augment_apply(t(imgs), choice, u, sign), want)


WRAPPERS = {
    "random_crop": (lambda g, im: T.random_crop(g, im, 24, 4),
                    lambda g, im: T.random_crop_at(
                        im, torch.randint(0, 9, (B,), generator=g),
                        torch.randint(0, 25, (B,), generator=g), 24, 4)),
    "gaussian_blur": (lambda g, im: T.gaussian_blur(g, im, (0.5, 1.5)),
                      lambda g, im: T.gaussian_blur_sigma(
                          im, 0.5 + torch.rand(B, generator=g))),
    "cutout": (lambda g, im: T.cutout(g, im, 2, 8),
               lambda g, im: T.cutout_at(im, torch.randint(1, 9, (B,), generator=g),
                                         torch.randint(0, 41, (B, 2, 2), generator=g), 2)),
    "rand_aug": (lambda g, im: T.rand_augment(g, im, 2),
                 lambda g, im: T.rand_augment_apply(im, *_rand_aug_draws(g, 2))),
}


def _rand_aug_draws(g, n_aug):
    rounds = [(torch.randint(0, 14, (B,), generator=g), torch.rand(B, generator=g),
               torch.where(torch.rand(B, generator=g) > 0.5, -1.0, 1.0))
              for _ in range(n_aug)]
    return [torch.stack(x) for x in zip(*rounds)]


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_draws_in_the_documented_order(name):
    """Each random op's wrapper equals its apply-given-draws function on
    draws taken from the generator in the order its docstring gives; gated
    by `apply_prob`, the gate's uniforms come first."""
    op, by_hand = WRAPPERS[name]
    got = op(torch.Generator().manual_seed(3), t(IMGS))
    np.testing.assert_array_equal(got.numpy(),
                                  by_hand(torch.Generator().manual_seed(3), t(IMGS)).numpy())
    if got.shape == IMGS.shape:
        gated = T._wrap_prob(op, 0.5, True)(torch.Generator().manual_seed(3), t(IMGS))
        g = torch.Generator().manual_seed(3)
        keep = (torch.rand(B, generator=g) < 0.5).reshape(-1, 1, 1, 1)
        want = torch.where(keep, by_hand(g, t(IMGS)), t(IMGS))
        np.testing.assert_array_equal(gated.numpy(), want.numpy())


def test_deterministic_pipeline_with_resize_matches_jax():
    cfg = {"resize": {"size": [20, 36]}, "center_crop": {"size": [16, 32]},
           "to_tensor": None, "normalize": {"mean": [0.5, 0.4, 0.3], "std": [0.2, 0.25, 0.3]}}
    u8 = (IMGS * 255).astype(np.uint8)
    want = jax.vmap(J.build_transform(cfg))(KEYS, u8)
    got = T.build_transform(cfg)(torch.Generator(), t(u8))
    _close(got, want)


def test_every_op_builds_in_a_batch_pipeline():
    """A train view with every random op of the slice after the fused pair:
    the shapes, [0, 1] before normalize, and no op left unported."""
    cfg = {"color_jitter": {"brightness": 0.4, "contrast": 0.4, "saturation": 0.4,
                            "hue": 0.1, "apply_prob": 0.8},
           "random_gray": {"p": 0.2},
           "random_crop": {"size": 32, "padding": 4},
           "resize": {"size": [28, 28], "method": "cubic"},
           "random_flip": None,
           "gaussian_blur": {"apply_prob": 0.5},
           "rand_aug": {"n_aug": 2},
           "cutout": {"n_cuts": 1, "max_len": 8}}
    u8 = np.random.RandomState(0).randint(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    out = T.build_batch_transform(cfg)(torch.Generator().manual_seed(0), t(u8))
    assert out.shape == (8, 28, 28, 3) and torch.isfinite(out).all()
