"""The port's bicubic crops, multi-crop views, ViT and DINO head against the
JAX package (ssv_tpu/data/augment.py, data/multicrop.py, models/vit.py,
models/heads.py), on the same inputs and weights (moved across by
ssv_tpu_torch/convert.py), in float32 on both sides, and the ViT and head
also in bf16 (the port under autocast, flax at dtype bfloat16), at a small
size (a 2-layer ViT of width 32 with 2 heads, 16x16 global and 8x8 local
crops)."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from ssv_tpu.data import augment as J
from ssv_tpu.models import heads as JH
from ssv_tpu.models.registry import build_encoder as jax_build_encoder
from ssv_tpu.models.vit import patchify
from ssv_tpu_torch.convert import dino_head_state_dict, vit_state_dict
from ssv_tpu_torch.data import augment as T
from ssv_tpu_torch.data.multicrop import MultiCrop
from ssv_tpu_torch.models import heads as TH
from ssv_tpu_torch.models.registry import build_encoder
from torch_helpers import strict_jit, t, to_numpy_tree

torch.set_num_threads(2)

rs = np.random.RandomState(0)
IMGS = rs.rand(6, 32, 32, 3).astype(np.float32)

VIT = {"hidden_dim": 32, "embedding_dim": 16, "intermediate_dim": 48,
       "num_attention_heads": 2, "patch_size": 4, "num_encoder_layers": 2,
       "num_global_patches": 16, "num_local_patches": 4}


# --------------------------------------------------------------------------
# bicubic crops and multi-crop views
# --------------------------------------------------------------------------

def _boxes(n, scale, seed):
    g = torch.Generator().manual_seed(seed)
    u = [torch.rand(n, 10, generator=g), torch.rand(n, 10, generator=g),
         torch.rand(n, generator=g), torch.rand(n, generator=g)]
    return T.sample_rrc_box((32, 32), scale, *u)


def _jax_crops(imgs, box, out_size):
    jbox = jnp.asarray(torch.stack(box, 1).numpy())
    return np.asarray(jax.vmap(
        lambda im, b: J.crop_resize(im, tuple(b), out_size, method="cubic"))(imgs, jbox))


# global crops (scale 0.3-1 at 32x32: the box is mostly smaller than the
# output, so upsampling), local crops (scale 0.08-0.3 to 8x8: the box of
# 9-17 px shrinks), and both directions mixed
@pytest.mark.parametrize("out_size,scale,direction", [
    ((32, 32), (0.3, 1.0), "up"), ((8, 8), (0.08, 0.3), "down"),
    ((16, 24), (0.08, 1.0), "mixed")], ids=["global-up", "local-down", "mixed"])
def test_cubic_crop_resize_matches_scale_and_translate(out_size, scale, direction):
    """Per-image boxes through Keys' cubic kernel (a = -0.5), antialiased,
    against jax.image.scale_and_translate(method="cubic", antialias=True),
    to 1e-5; the weights' negative lobes are kept (no clamp), so upsampled
    values leave [0, 1] as JAX's do."""
    box = _boxes(6, scale, seed=1)
    h, w = box[2].numpy(), box[3].numpy()
    if direction == "up":
        assert (h <= out_size[0]).all() and (w <= out_size[1]).all() and (h < out_size[0]).any()
    elif direction == "down":
        assert (h > out_size[0]).all() and (w > out_size[1]).all()
    else:
        assert (h < out_size[0]).any() and (h > out_size[0]).any()
    got = T.crop_resize(t(IMGS), box, out_size, method="cubic").numpy()
    want = _jax_crops(IMGS, box, out_size)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if direction == "up":
        assert got.min() < 0.0 and got.max() > 1.0
    # the linear path is untouched by the method switch
    np.testing.assert_array_equal(T.crop_resize(t(IMGS), box, out_size).numpy(),
                                  T.crop_resize(t(IMGS), box, out_size, "linear").numpy())
    with pytest.raises(ValueError, match="method"):
        T.crop_resize(t(IMGS), box, out_size, method="lanczos3")


def _multicrop_cfg():
    cfg = helpers.mini_config("dino")["data"]["multicrop_config"]
    cfg.update(num_global_views=2, num_local_views=3, global_size=[16, 16])
    return cfg


def test_multicrop_crops_one_box_per_view_from_given_uniforms():
    """A group's V crops are one RRC over the B*V images repeated in place:
    crop v of image b is row b*V + v, cut by its own box from the uniforms
    the generator gives, at the group's scale range; the result equals
    JAX's cubic crop of those boxes."""
    mc = MultiCrop(_multicrop_cfg())
    assert mc.global_scale == (0.3, 1.0) and mc.local_scale == (0.08, 0.3)
    B = IMGS.shape[0]
    for n, size, scale in ((mc.num_global, mc.global_size, mc.global_scale),
                           (mc.num_local, mc.local_size, mc.local_scale)):
        got = MultiCrop.crops(torch.Generator().manual_seed(5), t(IMGS), n, size, scale)
        assert got.shape == (B, n, *size, 3)
        # the same uniforms, in the order random_resized_crop draws them
        g = torch.Generator().manual_seed(5)
        u = [torch.rand(B * n, 10, generator=g), torch.rand(B * n, 10, generator=g)]
        u_ij = torch.rand(B * n, 2, generator=g)
        box = T.sample_rrc_box((32, 32), scale, *u, u_ij[:, 0], u_ij[:, 1])
        area = (box[2] * box[3]).numpy() / (32 * 32)
        # sizes round to whole pixels: the area may leave the range by a
        # pixel's width in each side
        slack = 2 * 33 / 1024
        assert (area >= scale[0] - slack).all() and (area <= scale[1] + slack).all()
        assert len({tuple(b) for b in torch.stack(box, 1).tolist()}) > B   # own boxes
        want = _jax_crops(np.repeat(IMGS, n, axis=0), box, size)
        np.testing.assert_allclose(got.reshape(B * n, *size, 3).numpy(), want,
                                   atol=1e-5, rtol=0)


def test_multicrop_batch_call_views_and_two_photometric_passes(monkeypatch):
    """The base transform runs twice over the batch, each a single pass of
    the fused photometric pair; the four groups come out (B, V, h, w, 3)
    float32, each group's crops cut from its own augmented batch."""
    from ssv_tpu_torch.data import augment

    calls = []
    fused = augment.fused_photometric

    def counted(images, order, params):
        calls.append(images.shape[0])
        return fused(images, order, params)

    monkeypatch.setattr(augment, "fused_photometric", counted)
    mc = MultiCrop(_multicrop_cfg())
    u8 = (IMGS * 255).astype(np.uint8)
    views = mc.batch_call(torch.Generator().manual_seed(0), t(u8))
    assert calls == [6, 6]
    shapes = {k: tuple(v.shape) for k, v in views.items()}
    assert shapes == {"global_1": (6, 2, 16, 16, 3), "global_2": (6, 2, 16, 16, 3),
                      "local_1": (6, 3, 8, 8, 3), "local_2": (6, 3, 8, 8, 3)}
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all() for v in views.values())
    assert not torch.equal(views["global_1"], views["global_2"])
    assert not torch.equal(views["local_1"][:, 0], views["local_1"][:, 1])


# --------------------------------------------------------------------------
# the ViT
# --------------------------------------------------------------------------

def _vit_pair(**cfg):
    """(flax encoder, its params as numpy, the port's encoder with them)."""
    jnet, dim = jax_build_encoder("vit", {**VIT, "dtype": "float32", **cfg})
    params = to_numpy_tree(jnet.init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3)))["params"])
    net, tdim = build_encoder("vit", {**VIT, **cfg})
    net.load_state_dict(vit_state_dict(params))
    assert dim == tdim == 32
    return jnet, params, net


@pytest.mark.parametrize("seq_pad_multiple", [0, 8])
@pytest.mark.parametrize("fuse_qkv", [False, True], ids=["qkv", "fused-qkv"])
def test_vit_forward_and_attention_maps(seq_pad_multiple, fuse_qkv):
    """The CLS output and every layer's attention map, for a global (16x16:
    16 patches, 17 tokens) and a local (8x8: 4 patches, 5 tokens) batch,
    against the flax encoder on the same params, to 1e-5; padded rows and
    columns are cut from the maps."""
    jnet, params, net = _vit_pair(seq_pad_multiple=seq_pad_multiple, fuse_qkv=fuse_qkv)
    apply = jax.jit(lambda p, x: jnet.apply({"params": p}, x, return_attn=True))
    for size, tokens in ((16, 17), (8, 5)):
        x = np.random.RandomState(size).rand(3, size, size, 3).astype(np.float32)
        want, want_attn = apply(params, jnp.asarray(x))
        got, attn = net(t(x), return_attn=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
        assert got.dtype == torch.float32 and set(attn) == set(want_attn) == {"layer_0",
                                                                              "layer_1"}
        for k, probs in attn.items():
            assert probs.shape == (3, 2, tokens, tokens)
            np.testing.assert_allclose(probs.detach().numpy(), np.asarray(want_attn[k]),
                                       atol=1e-5, rtol=0, err_msg=k)


def test_vit_patch_embedding_equals_patchify_concat_dense():
    """The conv embedding against the reference's formula on the same
    params: patchify (rows (c, py, px)), the CLS prepended, the position
    table concatenated on the feature axis, one Dense."""
    _, params, net = _vit_pair()
    p = params["projection_fc"]
    for size, n, table in ((16, 16, "pos_embedding_global"), (8, 4, "pos_embedding_local")):
        img = np.random.RandomState(n).rand(2, size, size, 3).astype(np.float32)
        x = np.asarray(patchify(jnp.asarray(img), 4))
        x = np.concatenate([np.broadcast_to(params["cls_embedding"], (2, 1, 48)), x], 1)
        x = np.concatenate([x, np.broadcast_to(params[table][None], (2, n + 1, 16))], -1)
        want = x @ p["kernel"] + p["bias"]
        got = net.embed(t(img), torch.float32).detach().numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_vit_rejects_other_patch_counts_and_inits_like_flax():
    """A count of patches matching neither table raises, as the JAX module
    does; init draws the flax scales: CLS and position tables N(0, 1),
    lecun-normal Dense kernels with zero biases, LayerNorm 1 and 0."""
    net, _ = build_encoder("vit", {**VIT, "num_encoder_layers": 1})
    net.init_weights(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="neither global"):
        net(torch.zeros(1, 12, 12, 3))
    assert abs(float(net.pos_embedding_global.detach().std()) - 1.0) < 0.15
    fc = net.projection_fc
    assert abs(float(fc.weight.detach().std()) * (fc.in_features ** 0.5) - 1.0) < 0.1
    assert fc.bias.eq(0).all()
    ln = net.layers[0].attention.ln
    assert ln.weight.eq(1).all() and ln.bias.eq(0).all() and ln.eps == 1e-6
    assert net.layers[0].attention.query.bias is None


# --------------------------------------------------------------------------
# bf16: where the dtype changes
# --------------------------------------------------------------------------

def _float32_gelu(x, approximate=True):
    """flax's GELU evaluated in float32 and rounded once, as torch's bf16
    GELU is: flax's own evaluates erf in bf16 steps with 1/sqrt(2) rounded
    to 0.70703125, which puts about a quarter of a bf16 feed-forward's
    outputs one bf16 step from the port's."""
    return jax.nn.gelu(x.astype(jnp.float32), approximate=approximate).astype(x.dtype)


def _perturbed(params, seed=1):
    """Params moved off their init (zero biases, unit LayerNorm) so that
    every bias and scale takes part in the rounding."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: a + 0.1 * rs.randn(*a.shape).astype(np.float32), params)


def bf16_vit_gaps(cfg):
    """The largest |port - flax| of the CLS output and of the attention
    maps, global (16x16) and local (8x8) batches, the port under
    torch.autocast("cpu", bfloat16) and the flax encoder at dtype bfloat16
    on the same params."""
    jnet, _ = jax_build_encoder("vit", {**VIT, "dtype": "bfloat16", **cfg})
    params = _perturbed(to_numpy_tree(
        jnet.init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3)))["params"]))
    net, _ = build_encoder("vit", {**VIT, **cfg})
    net.load_state_dict(vit_state_dict(params))
    gaps = {}
    for size in (16, 8):
        x = np.random.RandomState(size).rand(8, size, size, 3).astype(np.float32)
        want, want_attn = strict_jit(
            lambda p, xx: jnet.apply({"params": p}, xx, return_attn=True), params, jnp.asarray(x))
        with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
            got, attn = net(t(x), return_attn=True)
        assert got.dtype == torch.float32
        gaps[f"cls-{size}"] = float(np.abs(got.numpy() - np.asarray(want)).max())
        gaps[f"attn-{size}"] = max(float(np.abs(attn[k].numpy() - np.asarray(want_attn[k])).max())
                                   for k in attn)
    return gaps


@pytest.mark.parametrize("cfg", [{}, {"seq_pad_multiple": 8, "fuse_qkv": True}],
                         ids=["plain", "padded-fused-qkv"])
def test_vit_bf16_casts_match_flax(cfg, monkeypatch):
    """The ViT's explicit casts against flax's bf16 numerics, the reference
    compiled with excess precision off and its GELU taken in float32 (the
    two differences no cast of the port can follow): the CLS output bit for
    bit, the attention maps (float32) within 1e-6. Readings, largest gap of
    CLS / maps: this port 0 / 1.19e-7 (the float32 softmax's last bit). With
    one cast moved instead: the attention's LayerNorm output left float32
    0.0625 / 0.0157; the scores a bf16 product 0.0625 / 0.0119; probs @ V in
    float32 0.0625 / 0.0122; the feed-forward's LayerNorm output left float32
    0.0625 / 0.0097; a Dense's bias added before its product is rounded
    0.0938 / 0.0137. The smallest CLS gap of those on one batch is 0.0332,
    the smallest map gap 0.0070."""
    monkeypatch.setattr(nn, "gelu", _float32_gelu)
    gaps = bf16_vit_gaps(cfg)
    assert {k: v for k, v in gaps.items() if k.startswith("cls")} == {"cls-16": 0.0,
                                                                       "cls-8": 0.0}
    assert max(v for k, v in gaps.items() if k.startswith("attn")) <= 1e-6


def bf16_dino_head_gap():
    """The largest |port - flax| of DinoHead's output, the port under
    torch.autocast("cpu", bfloat16), flax's at dtype bfloat16."""
    x = np.random.RandomState(2).randn(16, 32).astype(np.float32)
    jm, tm = JH.DinoHead(64, 128, dtype=jnp.bfloat16), TH.DinoHead(32, 64, 128)
    params = _perturbed(to_numpy_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]))
    tm.load_state_dict(dino_head_state_dict(params))
    want = strict_jit(lambda p, xx: jm.apply({"params": p}, xx), params, jnp.asarray(x))
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = tm(t(x))
    assert got.dtype == torch.float32
    return float(np.abs(got.numpy() - np.asarray(want)).max())


def test_dino_head_bf16_matches_flax(monkeypatch):
    """DinoHead's casts against flax's bf16 head (same compile and GELU as
    above): the MLP in bf16, each Linear's product rounded before its bias
    is added; its output, the L2 normalisation and the weight-normed layer
    in float32. Within 1e-5; readings: this port 1.49e-7, with the MLP's
    output normalised in bf16 1.58e-3, with the MLP in float32 3.04e-3."""
    monkeypatch.setattr(nn, "gelu", _float32_gelu)
    assert bf16_dino_head_gap() <= 1e-5


# --------------------------------------------------------------------------
# the DINO head
# --------------------------------------------------------------------------

@pytest.mark.parametrize("module", ["weight_norm_dense", "dino_head"])
def test_dino_head_forward_and_gradients(module):
    """WeightNormDense (v * g / ||v||, g from ||v||) and DinoHead (3 GELU
    layers, L2 normalisation, the weight-normed layer) against flax: the
    output and the gradients of every parameter and of the input, to 1e-5."""
    x = np.random.RandomState(2).randn(5, 12).astype(np.float32)
    r = np.random.RandomState(3).randn(5, 16).astype(np.float32)
    if module == "weight_norm_dense":
        jm = JH.WeightNormDense(16)
        tm = TH.WeightNormDense(12, 16)
    else:
        jm = JH.DinoHead(24, 16, dtype=jnp.float32)
        tm = TH.DinoHead(12, 24, 16)
    params = to_numpy_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    fc = params if module == "weight_norm_dense" else params["fc_out"]
    np.testing.assert_allclose(fc["g"], np.linalg.norm(fc["v"], axis=0), rtol=1e-6)
    if module == "weight_norm_dense":
        sd = {"v": t(fc["v"].T), "g": t(fc["g"]), "bias": t(fc["bias"])}
    else:
        sd = dino_head_state_dict(params)
    tm.load_state_dict(sd)

    def loss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx) * r)

    want, (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    got = (tm(xt) * t(r)).sum()
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * max(1.0, abs(float(want)))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5, rtol=0)
    grads = {k: v.grad for k, v in tm.named_parameters()}
    gp = to_numpy_tree(gp)
    if module == "weight_norm_dense":
        want_grads = {"v": gp["v"].T, "g": gp["g"], "bias": gp["bias"]}
    else:
        want_grads = {k: v.numpy() for k, v in dino_head_state_dict(gp).items()}
    assert set(grads) == set(want_grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[k], atol=1e-5, rtol=0, err_msg=k)

    tm.init_weights(torch.Generator().manual_seed(0))
    wn = tm if module == "weight_norm_dense" else tm.fc_out
    torch.testing.assert_close(wn.g, torch.linalg.vector_norm(wn.v, dim=1))
