"""The shipped two-view train transform in plain PyTorch, float32: a frozen
copy of its semantics, for the reference step.

    ColorJitter(.4, .4, .4, .1) under RandomApply(.8) in a random order a
    image, RandomGrayscale(.2), RandomResizedCrop(32, scale .2-1, ratio
    3/4-4/3, antialiased bilinear), horizontal flip (.5), normalize.

Each view draws its uniforms from the generator in this order, one call
each: (B, 6) for the jitter's gate, four factors and the gray gate; (B, 4)
whose argsort is the op order; the crop's (B, 10) area and (B, 10) ratio
candidates and (B, 2) offsets; (B,) for the flip. The program under test
documents the same order for its transform, so both sides draw the same
numbers from a generator of the same seed on the same device. Nothing here
imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

GRAY = (0.299, 0.587, 0.114)


def gray(x):
    return GRAY[0] * x[..., 0] + GRAY[1] * x[..., 1] + GRAY[2] * x[..., 2]


def blend(a, b, f):
    return torch.clamp(f * a + (1.0 - f) * b, 0.0, 1.0)


def mod1(x):
    r = torch.fmod(x, 1.0)
    return torch.where(r < 0, r + 1.0, r)


def shift_hue(x, shift):
    """x (B, P, 3) in [0, 1], shift (B, 1): RGB -> HSV, h + shift mod 1,
    HSV -> RGB, as colorsys does it."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), torch.zeros_like(maxc))
    safe = torch.clamp(delta, min=1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, torch.zeros_like(h), mod1(h / 6.0))
    h = mod1(h + shift)
    v = maxc
    fi = torch.floor(h * 6.0)
    f = h * 6.0 - fi
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    sector = (fi.to(torch.int64) % 6)[..., None]
    table = torch.stack([torch.stack(c, -1) for c in (
        (v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))], -2)
    return torch.gather(table, -2, sector[..., None].expand(*sector.shape, 3))[..., 0, :]


def photometric(x, order, params):
    """x (B, H, W, 3) in [0, 1]; order (B, 4) a permutation of [brightness,
    contrast, saturation, hue]; params (B, 5) [fb, fc, fs, hue shift, gray
    gate]. A hue shift of exactly 0 leaves the image as it is."""
    B, H, W, C = x.shape
    x = x.reshape(B, H * W, C)
    fb, fc, fs, fh, gate = (params[:, k].reshape(B, 1, 1) for k in range(5))
    for j in range(4):
        op = order[:, j].long().reshape(B, 1, 1)
        mean = gray(x).mean(dim=1).reshape(B, 1, 1)
        y = torch.where(op == 0, torch.clamp(fb * x, 0.0, 1.0), x)
        y = torch.where(op == 1, blend(x, mean, fc), y)
        y = torch.where(op == 2, blend(x, gray(x)[..., None], fs), y)
        y = torch.where((op == 3) & (fh != 0), shift_hue(x, fh[..., 0]), y)
        x = y
    x = torch.where(gate > 0.5, gray(x)[..., None].expand_as(x), x)
    return x.reshape(B, H, W, C)


def jitter_params(n, jitter: dict, gray_p: float, apply_prob: float, generator, device):
    u = torch.rand(n, 6, generator=generator, device=device)
    on = u[:, 0] < apply_prob

    def factor(col, lo, hi, identity):
        return torch.where(on, lo + (hi - lo) * u[:, col], torch.full_like(u[:, col], identity))

    b, c, s, h = (float(jitter[k]) for k in ("brightness", "contrast", "saturation", "hue"))
    params = torch.stack([factor(1, max(0.0, 1 - b), 1 + b, 1.0),
                          factor(2, max(0.0, 1 - c), 1 + c, 1.0),
                          factor(3, max(0.0, 1 - s), 1 + s, 1.0),
                          factor(4, -h, h, 0.0),
                          (u[:, 5] < gray_p).float()], dim=1)
    order = torch.argsort(torch.rand(n, 4, generator=generator, device=device), dim=1)
    return order, params


def _uniform(u, lo, hi):
    lo, hi = np.float32(lo), np.float32(hi)
    return torch.clamp(u * float(hi - lo) + float(lo), min=float(lo))


def crop_box(size, scale, ratio, u_area, u_ratio, u_i, u_j):
    """torchvision's RandomResizedCrop box from given uniforms: the first of
    ten candidates that fits, else the centre crop; sizes round half to
    even, offsets truncate. (i, j, h, w) as float32 (B,)."""
    H, W = size
    area = float(H * W) * _uniform(u_area, *scale)
    ar = torch.exp(_uniform(u_ratio, math.log(ratio[0]), math.log(ratio[1])))
    ws = torch.round(torch.sqrt(area * ar)).to(torch.int32)
    hs = torch.round(torch.sqrt(area / ar)).to(torch.int32)
    ok = (ws > 0) & (ws <= W) & (hs > 0) & (hs <= H)
    first = torch.argmax(ok.to(torch.int32), dim=1, keepdim=True)
    h = torch.where(ok.any(1), torch.gather(hs, 1, first)[:, 0], torch.full_like(hs[:, 0], H))
    w = torch.where(ok.any(1), torch.gather(ws, 1, first)[:, 0], torch.full_like(ws[:, 0], W))
    i = torch.where(ok.any(1), (u_i * (H - h + 1).float()).to(torch.int32), (H - h) // 2)
    j = torch.where(ok.any(1), (u_j * (W - w + 1).float()).to(torch.int32), (W - w) // 2)
    return tuple(t.float() for t in (i, j, h, w))


def _weights(n_in, n_out, start, length):
    """(B, n_out, n_in) antialiased triangle weights that resample the span
    [start, start + length) of each row to n_out samples (the formula of
    jax.image.scale_and_translate)."""
    inv = (1.0 / (n_out / length))[:, None, None]
    trans = (-start * n_out / length)[:, None, None]
    pos = ((torch.arange(n_out, dtype=torch.float32, device=start.device) + 0.5)[None, None, :]
           * inv - trans * inv - 0.5)
    src = torch.arange(n_in, dtype=torch.float32, device=start.device)[None, :, None]
    w = torch.clamp(1.0 - torch.abs(pos - src) / torch.clamp(inv, min=1.0), min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    w = torch.where((pos >= -0.5) & (pos <= n_in - 0.5), w, torch.zeros_like(w))
    return w.transpose(1, 2)


def resized_crop(x, box, out):
    i, j, h, w = box
    _, H, W, _ = x.shape
    y = torch.einsum("boh,bhwc->bowc", _weights(H, out[0], i, h), x)
    return torch.einsum("bpw,bowc->bopc", _weights(W, out[1], j, w), y)


def train_view(generator, raw_u8, cfg: dict):
    """One view of the uint8 NHWC batch under `cfg` (the config's
    `data.transforms.train`), drawing from `generator`."""
    x = raw_u8.float() / torch.full((), 255.0, device=raw_u8.device)
    jitter = dict(cfg["color_jitter"])
    apply_prob = float(jitter.pop("apply_prob"))
    order, params = jitter_params(x.shape[0], jitter, float(cfg["random_gray"]["p"]),
                                  apply_prob, generator, x.device)
    x = photometric(x, order, params)
    rrc = cfg["random_resized_crop"]
    B, dev = x.shape[0], x.device
    u_area = torch.rand(B, 10, generator=generator, device=dev)
    u_ratio = torch.rand(B, 10, generator=generator, device=dev)
    u_ij = torch.rand(B, 2, generator=generator, device=dev)
    box = crop_box(x.shape[1:3], tuple(rrc["scale"]), (3.0 / 4.0, 4.0 / 3.0),
                   u_area, u_ratio, u_ij[:, 0], u_ij[:, 1])
    x = resized_crop(x, box, tuple(rrc["size"]))
    flip = torch.rand(B, generator=generator, device=dev) < 0.5
    x = torch.where(flip.reshape(-1, 1, 1, 1), x.flip(2), x)
    norm = cfg["normalize"]
    mean = torch.tensor(norm["mean"], dtype=torch.float32, device=dev)
    std = torch.tensor(norm["std"], dtype=torch.float32, device=dev)
    return (x - mean) / std
