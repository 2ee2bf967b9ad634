"""On-device image augmentations, batched, in PyTorch.

The port of ssv_tpu/data/augment.py for the ops the shipped configs' train
and test transforms use. Every function takes and returns a batch of NHWC
float images (B, H, W, 3) in [0, 1] (`to_float` converts uint8; `normalize`
may leave [0, 1] at the end of a pipeline). Random ops take a
`torch.Generator` first and draw one set of parameters per image on the
images' device; deterministic ops take none.

`build_transform(cfg)` compiles the reference's order-sensitive YAML mapping
(name -> kwargs, reserved key ``apply_prob``) into one function
`fn(generator, images)`. `build_batch_transform(cfg)` does the same, but
sends a leading [color_jitter, random_gray] pair through the fused
photometric kernel (ops/photometric.py) whenever the pipeline starts with it.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable

import torch

from ..ops.photometric import (_blend, _gray, _hue, fused_photometric,  # noqa: F401
                               hsv_to_rgb, photometric_reference, rgb_to_hsv,
                               sample_photometric_params)


# --------------------------------------------------------------------------
# basics
# --------------------------------------------------------------------------

def to_float(img_u8):
    return img_u8.to(torch.float32) / 255.0


def normalize(img, mean, std):
    mean = torch.as_tensor(mean, dtype=torch.float32, device=img.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=img.device)
    return (img - mean) / std


def rgb_to_grayscale(img, keep_channels: bool = True):
    gray = _gray(img)
    if keep_channels:
        gray = gray[..., None].expand(*gray.shape, img.shape[-1]).contiguous()
    return gray


def _per_image(factor, img):
    """A scalar, or one value per image (B,), broadcast against (B, H, W, C)."""
    if isinstance(factor, torch.Tensor) and factor.dim() == 1:
        return factor.reshape(-1, 1, 1, 1)
    return factor


# --------------------------------------------------------------------------
# color ops (torchvision ColorJitter semantics)
# --------------------------------------------------------------------------

def adjust_brightness(img, factor):
    return _blend(img, torch.zeros_like(img), _per_image(factor, img))


def adjust_contrast(img, factor):
    mean = rgb_to_grayscale(img, keep_channels=False).mean(dim=(-2, -1))
    return _blend(img, mean.reshape(-1, 1, 1, 1), _per_image(factor, img))


def adjust_saturation(img, factor):
    return _blend(img, rgb_to_grayscale(img), _per_image(factor, img))


def adjust_hue(img, shift):
    shift = _per_image(shift, img)
    return _hue(img, shift[..., 0] if isinstance(shift, torch.Tensor) else shift)


def color_jitter(generator, img, brightness=0.0, contrast=0.0, saturation=0.0,
                 hue=0.0):
    """torchvision.ColorJitter: per image, factors uniform in
    [max(0, 1-x), 1+x] (hue in [-h, h]) applied in a random order."""
    order, params = sample_photometric_params(
        img.shape[0], {"brightness": brightness, "contrast": contrast,
                       "saturation": saturation, "hue": hue},
        0.0, None, generator, img.device)
    return photometric_reference(img, order, params)


def random_grayscale(generator, img, p=0.1):
    u = torch.rand(img.shape[0], generator=generator, device=img.device)
    return torch.where((u < p).reshape(-1, 1, 1, 1), rgb_to_grayscale(img), img)


def random_flip(generator, img, p=0.5):
    u = torch.rand(img.shape[0], generator=generator, device=img.device)
    return torch.where((u < p).reshape(-1, 1, 1, 1), img.flip(2), img)


# --------------------------------------------------------------------------
# geometric ops
# --------------------------------------------------------------------------

def _weight_mat(in_size: int, out_size: int, scale, translation):
    """(B, out, in) linear-interpolation weights with antialiasing, the
    formula of jax.image.scale_and_translate's compute_weight_mat:
    sample positions, triangle kernel widened by 1/scale when downsampling,
    renormalised columns, and zero weight for samples outside the input."""
    dev = scale.device
    inv_scale = (1.0 / scale)[:, None, None]                     # (B, 1, 1)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    out_pos = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample_f = ((out_pos + 0.5)[None, None, :] * inv_scale
                - translation[:, None, None] * inv_scale - 0.5)  # (B, 1, out)
    in_pos = torch.arange(in_size, dtype=torch.float32, device=dev)[None, :, None]
    x = torch.abs(sample_f - in_pos) / kernel_scale              # (B, in, out)
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = weights.sum(dim=1, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(torch.abs(total) > eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    weights = torch.where(inside, weights, torch.zeros_like(weights))
    return weights.transpose(1, 2)                               # (B, out, in)


def crop_resize(img, box_ijhw, out_size):
    """Resample each image's box (i, j, h, w), given per image as (B,)
    tensors, to `out_size` = (H, W) with antialiased linear interpolation:
    one (out, in) weight matrix per image and axis, two batched matmuls."""
    i, j, h, w = (b.to(torch.float32) for b in box_ijhw)
    out_h, out_w = out_size
    _, H, W, _ = img.shape
    rows = _weight_mat(H, out_h, out_h / h, -i * out_h / h)      # (B, out_h, H)
    cols = _weight_mat(W, out_w, out_w / w, -j * out_w / w)      # (B, out_w, W)
    y = torch.einsum("boh,bhwc->bowc", rows, img)
    return torch.einsum("bpw,bowc->bopc", cols, y)


def sample_rrc_box(in_size, scale, u_area, u_ratio, u_i, u_j,
                   ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """torchvision RandomResizedCrop.get_params, batched and given its
    uniforms in [0, 1): u_area and u_ratio (B, 10) for the ten
    rejection-sampling candidates (the first valid one wins, else an
    aspect-clamped centre crop), u_i and u_j (B,) for the offsets.
    Sizes round half to even and offsets truncate, as the JAX version does.
    Returns (i, j, h, w), each (B,) int32."""
    H, W = in_size
    dev = u_area.device

    def uniform(u, lo, hi):
        lo = torch.tensor(lo, dtype=torch.float32, device=dev)
        hi = torch.tensor(hi, dtype=torch.float32, device=dev)
        return torch.maximum(lo, u * (hi - lo) + lo)

    target_area = float(H * W) * uniform(u_area, scale[0], scale[1])
    ar = torch.exp(uniform(u_ratio, math.log(ratio[0]), math.log(ratio[1])))
    ws = torch.round(torch.sqrt(target_area * ar)).to(torch.int32)
    hs = torch.round(torch.sqrt(target_area / ar)).to(torch.int32)
    valid = (ws > 0) & (ws <= W) & (hs > 0) & (hs <= H)
    idx = torch.argmax(valid.to(torch.int32), dim=1, keepdim=True)  # first valid
    any_valid = valid.any(dim=1)
    h = torch.gather(hs, 1, idx)[:, 0]
    w = torch.gather(ws, 1, idx)[:, 0]

    in_ratio = W / H
    if in_ratio < ratio[0]:
        fw, fh = W, int(round(W / ratio[0]))
    elif in_ratio > ratio[1]:
        fh, fw = H, int(round(H * ratio[1]))
    else:
        fw, fh = W, H
    h = torch.where(any_valid, h, torch.full_like(h, fh))
    w = torch.where(any_valid, w, torch.full_like(w, fw))
    i = torch.where(any_valid, (u_i * (H - h + 1).to(torch.float32)).to(torch.int32),
                    (H - h) // 2)
    j = torch.where(any_valid, (u_j * (W - w + 1).to(torch.float32)).to(torch.int32),
                    (W - w) // 2)
    return i, j, h, w


def random_resized_crop(generator, img, size, scale=(0.08, 1.0),
                        ratio=(3.0 / 4.0, 4.0 / 3.0)):
    size = (size, size) if isinstance(size, int) else tuple(size)
    B, dev = img.shape[0], img.device
    u_area = torch.rand(B, 10, generator=generator, device=dev)
    u_ratio = torch.rand(B, 10, generator=generator, device=dev)
    u_ij = torch.rand(B, 2, generator=generator, device=dev)
    box = sample_rrc_box(img.shape[1:3], tuple(scale), u_area, u_ratio,
                         u_ij[:, 0], u_ij[:, 1], tuple(ratio))
    return crop_resize(img, box, size)


def center_crop(img, size):
    size = (size, size) if isinstance(size, int) else tuple(size)
    H, W = img.shape[1:3]
    i, j = (H - size[0]) // 2, (W - size[1]) // 2
    return img[:, i:i + size[0], j:j + size[1], :]


# --------------------------------------------------------------------------
# pipeline compiler (reference get_transform, augmentations.py:128-144)
# --------------------------------------------------------------------------

def _wrap_prob(fn: Callable, p: float, random_op: bool):
    """RandomApply: gate a shape-preserving op with probability p per image."""
    def gated(generator, img):
        u = torch.rand(img.shape[0], generator=generator, device=img.device)
        out = fn(generator, img) if random_op else fn(img)
        return torch.where((u < p).reshape(-1, 1, 1, 1), out, img)
    return gated


# name -> (fn, needs_generator, shape_preserving)
TRANSFORM_OPS = {
    "color_jitter": (color_jitter, True, True),
    "random_gray": (random_grayscale, True, True),
    "random_resized_crop": (random_resized_crop, True, False),
    "center_crop": (center_crop, False, False),
    "random_flip": (random_flip, True, True),
    "to_tensor": (None, False, True),   # layout/scaling handled by to_float
    "normalize": (normalize, False, True),
}

# ops of the JAX package that no shipped config's main path uses yet
NOT_PORTED = ("gaussian_blur", "random_crop", "resize", "rand_aug", "cutout")


def _compile_steps(cfg: dict):
    """name->kwargs mapping -> list of (name, fn, needs_generator) steps.
    An op that is not yet ported raises here, when the transform is built."""
    cfg = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in dict(cfg or {}).items()}
    steps = []
    for name, kwargs in cfg.items():
        if name in NOT_PORTED:
            raise NotImplementedError(
                f"transform {name!r} is not yet ported to ssv_tpu_torch "
                f"(ROADMAP slice C)")
        if name not in TRANSFORM_OPS:
            raise ValueError(f"Unknown transform {name!r}")
        fn, needs_gen, shape_preserving = TRANSFORM_OPS[name]
        if name == "to_tensor":
            continue
        kwargs = dict(kwargs or {})
        p = kwargs.pop("apply_prob", None)
        bound = partial(fn, **kwargs) if kwargs else fn
        if p is not None:
            if not shape_preserving:
                raise ValueError(f"apply_prob on shape-changing op {name!r}")
            steps.append((name, _wrap_prob(bound, float(p), needs_gen), True))
        else:
            steps.append((name, bound, needs_gen))
    return steps


def _run_steps(steps, generator, img):
    if img.dtype == torch.uint8:
        img = to_float(img)
    for _, fn, needs_gen in steps:
        img = fn(generator, img) if needs_gen else fn(img)
    return img


def build_transform(cfg: dict) -> Callable:
    """Compile an ordered name->kwargs mapping (the reference YAML transform
    schema) into `fn(generator, images_u8_or_f32) -> float32 images`, applied
    in YAML order; a `None` value means default kwargs; `apply_prob` wraps
    the op in RandomApply; `to_tensor` is a no-op marker."""
    steps = _compile_steps(cfg)
    return partial(_run_steps, steps)


def build_batch_transform(cfg: dict) -> Callable:
    """Like `build_transform`, but a leading [color_jitter, random_gray]
    pair (every shipped train config starts with it) runs as one fused
    photometric pass: the kernel for CUDA images, its plain version for CPU
    images. The remaining ops follow in YAML order."""
    steps = _compile_steps(cfg)
    names = [s[0] for s in steps]
    if names[:2] != ["color_jitter", "random_gray"]:
        return partial(_run_steps, steps)

    jitter_cfg = dict(cfg["color_jitter"] or {})
    apply_prob = jitter_cfg.pop("apply_prob", None)
    gray_p = float((cfg["random_gray"] or {}).get("p", 0.1))
    rest = steps[2:]

    def transform(generator, imgs):
        if imgs.dtype == torch.uint8:
            imgs = to_float(imgs)
        order, params = sample_photometric_params(
            imgs.shape[0], jitter_cfg, gray_p, apply_prob, generator, imgs.device)
        out = fused_photometric(imgs.contiguous(), order, params)
        return _run_steps(rest, generator, out)

    return transform
