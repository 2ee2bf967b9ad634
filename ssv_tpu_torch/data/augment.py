"""On-device image augmentations, batched, in PyTorch.

The port of ssv_tpu/data/augment.py. Every function takes and returns a
batch of NHWC float images (B, H, W, 3) in [0, 1] (`to_float` converts
uint8; `normalize` may leave [0, 1] at the end of a pipeline). Random ops
take a `torch.Generator` first and draw one set of parameters per image on
the images' device, in the order each op's docstring gives; deterministic
ops take none. Each random op is split in two: a function that applies
given draws per image (`random_crop_at`, `gaussian_blur_sigma`,
`cutout_at`, `rand_augment_apply`, `sample_rrc_box` + `crop_resize`), and
the wrapper that draws them. torch cannot reproduce `jax.random`, so the
tests hand the first one the JAX package's draws.

`build_transform(cfg)` compiles the reference's order-sensitive YAML mapping
(name -> kwargs, reserved key ``apply_prob``) into one function
`fn(generator, images)`. `build_batch_transform(cfg)` does the same, but
sends a leading [color_jitter, random_gray] pair through the fused
photometric kernel (ops/photometric.py) whenever the pipeline starts with it.
"""

from __future__ import annotations

import math
from functools import lru_cache, partial
from typing import Callable

import numpy as np
import torch

from ..ops.photometric import (_blend, _gray, _hue, fused_photometric,  # noqa: F401
                               hsv_to_rgb, photometric_reference, rgb_to_hsv,
                               sample_photometric_params)


# --------------------------------------------------------------------------
# basics
# --------------------------------------------------------------------------

def _div255(x):
    """x / 255 by IEEE division on any device: CUDA divides by a Python
    scalar as a multiply by its reciprocal, one rounding more than JAX's
    division."""
    return x / torch.full((), 255.0, device=x.device)


def to_float(img_u8):
    return _div255(img_u8.to(torch.float32))


@lru_cache(maxsize=None)
def _channel_constant(values: tuple, device: torch.device) -> torch.Tensor:
    """A per-channel float32 constant on `device`, copied there at its first
    use: a step the trainer captures as a CUDA graph copies nothing from the
    host, and its eager warm-up makes the copy first."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def normalize(img, mean, std):
    mean, std = (_channel_constant(tuple(map(float, v)), img.device) for v in (mean, std))
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

def _pair(size):
    return (size, size) if isinstance(size, int) else tuple(size)


def _triangle(x):
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def _keys_cubic(x):
    """Keys' cubic convolution kernel with a = -0.5 at |x| (x >= 0), as
    jax.image.scale_and_translate's `cubic` fills it; its weights go
    negative on 1 <= x < 2 and are not clamped."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


INTERPOLATION = {"linear": _triangle, "cubic": _keys_cubic}


def _weight_mat(in_size: int, out_size: int, inv_scale, translation,
                method: str = "linear"):
    """(B, out, in) interpolation weights with antialiasing, the formula of
    jax.image.scale_and_translate's compute_weight_mat, given each image's
    1/scale and translation (B,): sample positions, the kernel (`linear`:
    triangle, `cubic`: Keys) widened by 1/scale when downsampling,
    renormalised columns, and zero weight for samples outside the input."""
    dev = inv_scale.device
    inv_scale = inv_scale[:, None, None]                         # (B, 1, 1)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    out_pos = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample_f = ((out_pos + 0.5)[None, None, :] * inv_scale
                - translation[:, None, None] * inv_scale - 0.5)  # (B, 1, out)
    in_pos = torch.arange(in_size, dtype=torch.float32, device=dev)[None, :, None]
    x = torch.abs(sample_f - in_pos) / kernel_scale              # (B, in, out)
    weights = INTERPOLATION[method](x)
    total = weights.sum(dim=1, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(torch.abs(total) > eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    weights = torch.where(inside, weights, torch.zeros_like(weights))
    return weights.transpose(1, 2)                               # (B, out, in)


def _resample(img, rows, cols, out_size, method: str):
    """Each image resampled to `out_size` = (H, W), given (1/scale,
    translation) per image for its rows and its columns: one (out, in)
    weight matrix per image and axis, two batched matmuls."""
    if method not in INTERPOLATION:
        raise ValueError(f"method must be one of {list(INTERPOLATION)}, got {method!r}")
    out_h, out_w = out_size
    _, H, W, _ = img.shape
    y = torch.einsum("boh,bhwc->bowc", _weight_mat(H, out_h, *rows, method), img)
    return torch.einsum("bpw,bowc->bopc", _weight_mat(W, out_w, *cols, method), y)


def crop_resize(img, box_ijhw, out_size, method: str = "linear"):
    """Resample each image's box (i, j, h, w), given per image as (B,)
    tensors, to `out_size` = (H, W) with antialiased `linear` or `cubic`
    interpolation (the scales float32, as the JAX version's)."""
    i, j, h, w = (b.to(torch.float32) for b in box_ijhw)
    out_h, out_w = out_size
    return _resample(img, (1.0 / (out_h / h), -i * out_h / h),
                     (1.0 / (out_w / w), -j * out_w / w), out_size, method)


def _uniform(u, lo: float, hi: float):
    """u in [0, 1) mapped to [lo, hi) in float32, as max(lo, u (hi - lo) +
    lo) with lo, hi and their difference rounded to float32 (host numbers:
    no copy to the device inside a step)."""
    lo, hi = np.float32(lo), np.float32(hi)
    return torch.clamp(u * float(hi - lo) + float(lo), min=float(lo))


def sample_rrc_box(in_size, scale, u_area, u_ratio, u_i, u_j,
                   ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """torchvision RandomResizedCrop.get_params, batched and given its
    uniforms in [0, 1): u_area and u_ratio (B, 10) for the ten
    rejection-sampling candidates (the first valid one wins, else an
    aspect-clamped centre crop), u_i and u_j (B,) for the offsets.
    Sizes round half to even and offsets truncate, as the JAX version does.
    Returns (i, j, h, w), each (B,) int32."""
    H, W = in_size
    target_area = float(H * W) * _uniform(u_area, scale[0], scale[1])
    ar = torch.exp(_uniform(u_ratio, math.log(ratio[0]), math.log(ratio[1])))
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
                        ratio=(3.0 / 4.0, 4.0 / 3.0), method: str = "linear"):
    """One box per image from `sample_rrc_box`, its uniforms drawn from
    `generator` (u_area, u_ratio, then the offsets), resampled to `size`."""
    size = _pair(size)
    B, dev = img.shape[0], img.device
    u_area = torch.rand(B, 10, generator=generator, device=dev)
    u_ratio = torch.rand(B, 10, generator=generator, device=dev)
    u_ij = torch.rand(B, 2, generator=generator, device=dev)
    box = sample_rrc_box(img.shape[1:3], tuple(scale), u_area, u_ratio,
                         u_ij[:, 0], u_ij[:, 1], tuple(ratio))
    return crop_resize(img, box, size, method)


def center_crop(img, size):
    size = _pair(size)
    H, W = img.shape[1:3]
    i, j = (H - size[0]) // 2, (W - size[1]) // 2
    return img[:, i:i + size[0], j:j + size[1], :]


def random_crop_at(img, i, j, size, padding: int = 0):
    """Each image's (size) window at rows i.., columns j.. ((B,) integer
    tensors) of the image zero-padded by `padding` on each side."""
    h, w = _pair(size)
    if padding:
        img = torch.nn.functional.pad(img, (0, 0, padding, padding, padding, padding))
    dev = img.device
    rows = i.to(torch.long)[:, None] + torch.arange(h, device=dev)          # (B, h)
    cols = j.to(torch.long)[:, None] + torch.arange(w, device=dev)          # (B, w)
    b = torch.arange(img.shape[0], device=dev)[:, None, None]
    return img[b, rows[:, :, None], cols[:, None, :]]


def random_crop(generator, img, size, padding: int = 0):
    """torchvision RandomCrop: draws each image's row offset in
    [0, H + 2 padding - h], then its column offset, as integers."""
    h, w = _pair(size)
    B, H, W, _ = img.shape
    kw = {"generator": generator, "device": img.device}
    i = torch.randint(0, H + 2 * padding - h + 1, (B,), **kw)
    j = torch.randint(0, W + 2 * padding - w + 1, (B,), **kw)
    return random_crop_at(img, i, j, (h, w), padding)


def resize(img, size, method: str = "linear"):
    """jax.image.resize: antialiased `linear` or `cubic` resampling of the
    whole image (the port takes no other method), 1/scale = 1 / (out / in)
    in double precision, then float32, as jax.image.resize takes it."""
    out = _pair(size)
    B, H, W, _ = img.shape

    def axis(n_in, n_out):
        return (torch.full((B,), 1.0 / (n_out / n_in), device=img.device),
                torch.zeros(B, device=img.device))

    return _resample(img, axis(H, out[0]), axis(W, out[1]), out, method)


def affine_warp(img, matrix):
    """Inverse-mapped affine warp with bilinear sampling and zero fill (PIL
    Image.transform(AFFINE)). `matrix` (B, 6) = (a, b, c, d, e, f) per
    image: output (x, y) samples input (a x + b y + c, d x + e y + f), x the
    column."""
    B, H, W, C = img.shape
    dev = img.device
    a, b, c, d, e, f = (m.reshape(B, 1, 1) for m in matrix.to(torch.float32).unbind(1))
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    src_x = a * xx + b * yy + c
    src_y = d * xx + e * yy + f
    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    wx, wy = (src_x - x0)[..., None], (src_y - y0)[..., None]
    flat = img.reshape(B, H * W, C)

    def gather(yi, xi):
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = yi.clamp(0, H - 1).to(torch.long) * W + xi.clamp(0, W - 1).to(torch.long)
        vals = torch.gather(flat, 1, idx.reshape(B, H * W, 1).expand(-1, -1, C))
        return torch.where(inb[..., None], vals.reshape(B, H, W, C), 0.0)

    top = gather(y0, x0) * (1 - wx) + gather(y0, x0 + 1) * wx
    bot = gather(y0 + 1, x0) * (1 - wx) + gather(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def _affine(img, *entries):
    """affine_warp with matrix entries that are scalars or (B,) tensors."""
    B = img.shape[0]
    cols = [e.to(torch.float32) if isinstance(e, torch.Tensor)
            else torch.full((B,), float(e), device=img.device) for e in entries]
    return affine_warp(img, torch.stack(cols, 1))


def rotate(img, degrees):
    """PIL Image.rotate(angle) for (B,) angles: counter-clockwise about
    ((W - 1)/2, (H - 1)/2), expand=False."""
    H, W = img.shape[1:3]
    theta = -torch.deg2rad(degrees.to(torch.float32))
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    a, b, d, e = cos, sin, -sin, cos
    return _affine(img, a, b, cx - a * cx - b * cy, d, e, cy - d * cx - e * cy)


# --------------------------------------------------------------------------
# filters
# --------------------------------------------------------------------------

def _edge_pad(img, dim: int, r: int):
    """`img` padded by r on both sides of `dim` (1: rows, 2: columns) with
    its edge values."""
    n = img.shape[dim]
    idx = torch.arange(-r, n + r, device=img.device).clamp(0, n - 1)
    return img.index_select(dim, idx)


def gaussian_blur_sigma(img, sigma, kernel_radius: int = 4):
    """Separable blur of each image with its sigma ((B,)): 2r + 1 taps
    exp(-x^2 / 2 max(sigma, 1e-3)^2), normalised; edge padding; the
    vertical pass, then the horizontal one, each summing the shifted slices
    in order, as the JAX version does."""
    r = kernel_radius
    H, W = img.shape[1:3]
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    s = torch.clamp(sigma.to(torch.float32), min=1e-3)[:, None]
    k = torch.exp(-0.5 * (x / s) ** 2)
    k = (k / k.sum(dim=1, keepdim=True)).reshape(-1, 2 * r + 1, 1, 1, 1)
    pad = _edge_pad(img, 1, r)
    vert = pad[:, 0:H] * k[:, 0]
    for i in range(1, 2 * r + 1):
        vert = vert + pad[:, i:i + H] * k[:, i]
    pad = _edge_pad(vert, 2, r)
    horz = pad[:, :, 0:W] * k[:, 0]
    for i in range(1, 2 * r + 1):
        horz = horz + pad[:, :, i:i + W] * k[:, i]
    return horz


def gaussian_blur(generator, img, sigma=(0.1, 2.0), kernel_radius: int = 4):
    """PIL GaussianBlur with radius ~ U[sigma0, sigma1]: draws one uniform
    per image."""
    u = torch.rand(img.shape[0], generator=generator, device=img.device)
    return gaussian_blur_sigma(img, _uniform(u, *sigma), kernel_radius)


# PIL's smooth filter, each weight rounded to float32 as the JAX version's
_SMOOTH = (torch.tensor([[1, 1, 1], [1, 5, 1], [1, 1, 1]], dtype=torch.float32) / 13.0).tolist()


def sharpness(img, factor):
    """PIL ImageEnhance.Sharpness: blend with the 3x3 smooth filter
    [[1,1,1],[1,5,1],[1,1,1]]/13, the 1-pixel border kept from the image."""
    B, H, W, _ = img.shape
    k = _SMOOTH
    pad = _edge_pad(_edge_pad(img, 1, 1), 2, 1)
    smooth = pad[:, 0:H, 0:W] * k[0][0]
    for i in range(3):
        for j in range(3):
            if i or j:
                smooth = smooth + pad[:, i:i + H, j:j + W] * k[i][j]
    inner = torch.zeros(H, W, 1, dtype=torch.bool, device=img.device)
    inner[1:H - 1, 1:W - 1].fill_(True)   # a fill on the device, no host copy
    smooth = torch.where(inner, smooth, img)
    return _blend(img, smooth, _per_image(factor, img))


def cutout_at(img, cut_len, xs, n_cuts: int):
    """Zeroes each image's `n_cuts` squares of side about `cut_len` ((B,),
    shared by an image's cuts), centred at x = xs[:, n, 0] mod (W + 1) (a
    column) and y = xs[:, n, 1] mod (H + 1) (a row), clipped to the image."""
    B, H, W, _ = img.shape
    dev = img.device
    yy = torch.arange(H, device=dev)[None, :, None]
    xx = torch.arange(W, device=dev)[None, None, :]
    half = (cut_len // 2).reshape(B, 1, 1)
    mask = torch.ones(B, H, W, device=dev)
    for n in range(n_cuts):
        x = (xs[:, n, 0] % (W + 1)).reshape(B, 1, 1)
        y = (xs[:, n, 1] % (H + 1)).reshape(B, 1, 1)
        x1, x2 = (x - half).clamp(0, W), (x + half).clamp(0, W)
        y1, y2 = (y - half).clamp(0, H), (y + half).clamp(0, H)
        hole = (yy >= y1) & (yy < y2) & (xx >= x1) & (xx < x2)
        mask = torch.where(hole, 0.0, mask)
    return img * mask[..., None]


def cutout(generator, img, n_cuts: int = 0, max_len: int = 1):
    """Random square occlusions: draws each image's cut length in
    [1, max_len], then its (max(n_cuts, 1), 2) centres in [0, max(W, H)]."""
    B, H, W, _ = img.shape
    kw = {"generator": generator, "device": img.device}
    cut_len = torch.randint(1, max_len + 1, (B,), **kw)
    xs = torch.randint(0, max(W, H) + 1, (B, max(n_cuts, 1), 2), **kw)
    return cutout_at(img, cut_len, xs, n_cuts)


# --------------------------------------------------------------------------
# RandAugment ops (reference augmentations.py:43-109)
# --------------------------------------------------------------------------

def solarize(img, threshold):
    """PIL ImageOps.solarize: invert pixels >= threshold (in u8 units)."""
    return torch.where(img * 255.0 >= _per_image(threshold, img), 1.0 - img, img)


def posterize(img, bits):
    """PIL ImageOps.posterize: keep each image's `bits` high bits."""
    bits = torch.as_tensor(bits, device=img.device).to(torch.int32).clamp(1, 8)
    shift = _per_image(8 - bits, img)
    q = torch.floor(img * 255.0).to(torch.int32)
    return _div255(((q >> shift) << shift).to(torch.float32))


def autocontrast(img):
    """Per-image, per-channel min/max stretch (PIL ImageOps.autocontrast,
    cutoff 0)."""
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    scale = torch.where(hi > lo, 1.0 / (hi - lo), 1.0)
    off = torch.where(hi > lo, lo, 0.0)
    return torch.clamp((img - off) * scale, 0.0, 1.0)


def equalize(img):
    """Per-image, per-channel histogram equalisation of round(x * 255)
    clipped to [0, 255], with PIL's step/LUT rule; a channel whose step is 0
    is left as it is. One scatter_add over (B * 3, 256) bins."""
    B, H, W, C = img.shape
    q = torch.clamp(torch.round(img * 255.0), 0, 255).to(torch.long)
    q = q.permute(0, 3, 1, 2).reshape(B * C, H * W)
    hist = torch.zeros(B * C, 256, dtype=torch.long, device=img.device)
    hist.scatter_add_(1, q, torch.ones_like(q))
    bins = torch.arange(256, device=img.device)
    last = torch.where(hist > 0, bins, 0).amax(dim=1, keepdim=True)
    step = (H * W - hist.gather(1, last)) // 255                      # (B*C, 1)
    cum = hist.cumsum(dim=1)
    lut = ((cum - hist + step // 2) // step.clamp(min=1)).clamp(0, 255)
    out = _div255(lut.gather(1, q).to(torch.float32))
    out = out.reshape(B, C, H, W).permute(0, 2, 3, 1)
    return torch.where((step > 0).reshape(B, 1, 1, C), out, img)


def shear_x(img, v):
    return _affine(img, 1.0, v, 0.0, 0.0, 1.0, 0.0)


def shear_y(img, v):
    return _affine(img, 1.0, 0.0, 0.0, v, 1.0, 0.0)


def translate_x(img, v_frac):
    return _affine(img, 1.0, 0.0, v_frac * img.shape[2], 0.0, 1.0, 0.0)


def translate_y(img, v_frac):
    return _affine(img, 1.0, 0.0, 0.0, 0.0, 1.0, v_frac * img.shape[1])


RANDAUG_OPS = [
    # (name, min_v, max_v, signed, fn(images, v (B,))), the reference's ranges:
    # color, contrast, brightness, sharpness, solarize and posterize have
    # lo = hi, so the first four are the identity (kept, as in the JAX version)
    ("identity", 1, 1, False, lambda im, v: im),
    ("autocontrast", 1, 1, False, lambda im, v: autocontrast(im)),
    ("equalize", 1, 1, False, lambda im, v: equalize(im)),
    ("rotate", -30, 30, True, rotate),
    ("solarize", 1, 1, False, solarize),
    ("color", 1, 1, False, lambda im, v: adjust_saturation(im, v)),
    ("contrast", 1, 1, False, lambda im, v: adjust_contrast(im, v)),
    ("brightness", 1, 1, False, lambda im, v: adjust_brightness(im, v)),
    ("sharpness", 1, 1, False, sharpness),
    ("shear_x", -0.1, 0.1, True, shear_x),
    ("shear_y", -0.1, 0.1, True, shear_y),
    ("translate_x", -0.1, 0.1, True, translate_x),
    ("translate_y", -0.1, 0.1, True, translate_y),
    ("posterize", 1, 1, False, posterize),
]


def rand_augment_apply(img, choice, u, sign):
    """The reference's RandAugment given its draws, (n_aug, B) each: in
    round r image b takes op choice[r, b] with magnitude
    v = lo + (hi - lo) u[r, b], times sign[r, b] (+-1) for the signed ops.
    Every op runs on the whole batch and each image keeps its own op's
    result, as `lax.switch` under `vmap` does."""
    for r in range(choice.shape[0]):
        out = img
        for c, (_, lo, hi, signed, fn) in enumerate(RANDAUG_OPS):
            v = lo + (hi - lo) * u[r]
            if signed:
                v = v * sign[r]
            out = torch.where((choice[r] == c).reshape(-1, 1, 1, 1), fn(img, v), out)
        img = out
    return img


def rand_augment(generator, img, n_aug: int = 4):
    """n_aug ops per image chosen with replacement from RANDAUG_OPS; draws,
    in each round, the images' op choices, then their magnitude uniforms,
    then the uniforms whose > 0.5 makes a signed op's magnitude negative."""
    if not n_aug:
        return img
    B, dev = img.shape[0], img.device
    choice, u, sign = [], [], []
    for _ in range(n_aug):
        choice.append(torch.randint(0, len(RANDAUG_OPS), (B,), generator=generator, device=dev))
        u.append(torch.rand(B, generator=generator, device=dev))
        flip = torch.rand(B, generator=generator, device=dev) > 0.5
        sign.append(torch.where(flip, -1.0, 1.0))
    return rand_augment_apply(img, torch.stack(choice), torch.stack(u), torch.stack(sign))


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
    "gaussian_blur": (gaussian_blur, True, True),
    "color_jitter": (color_jitter, True, True),
    "random_gray": (random_grayscale, True, True),
    "random_crop": (random_crop, True, False),
    "random_resized_crop": (random_resized_crop, True, False),
    "center_crop": (center_crop, False, False),
    "resize": (resize, False, False),
    "random_flip": (random_flip, True, True),
    "to_tensor": (None, False, True),   # layout/scaling handled by to_float
    "normalize": (normalize, False, True),
    "rand_aug": (rand_augment, True, True),
    "cutout": (cutout, True, True),
}


def _compile_steps(cfg: dict):
    """name->kwargs mapping -> list of (name, fn, needs_generator) steps."""
    cfg = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in dict(cfg or {}).items()}
    steps = []
    for name, kwargs in cfg.items():
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
