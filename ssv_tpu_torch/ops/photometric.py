"""Fused photometric augmentation: ColorJitter in a per-image order, then the
grayscale gate, over a batch of NHWC float images in [0, 1].

`fused_photometric` replaces the Pallas TPU kernel of the same name in
ssv_tpu/ops/pallas/photometric.py. On a CUDA tensor it launches the
hand-written kernel in csrc/photometric.cu, which reads each pixel once,
keeps it in registers through all four ops (up to 64x64 pixels; larger
images take one pass per op), and writes it once; one CTA of 256 threads per
image, with a block reduction for contrast's mean. At the main path's batch
the instructions of its op chain, not its bytes (about 24 KB read and
written per 32x32 image), set its time. On a CPU tensor it runs
`photometric_reference`, the plain PyTorch version the CPU tests hold
against JAX and the chip check holds the kernel against.

`sample_photometric_params` draws the per-image (order, params) on the
device from a `torch.Generator`, folding the RandomApply gate into identity
factors as the JAX sampler does.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import trace

GRAY_W = (0.299, 0.587, 0.114)


def _gray(x):
    return GRAY_W[0] * x[..., 0] + GRAY_W[1] * x[..., 1] + GRAY_W[2] * x[..., 2]


def _blend(a, b, f):
    return torch.clamp(f * a + (1.0 - f) * b, 0.0, 1.0)


def _mod1(x):
    """Float remainder by 1 with the divisor's sign (JAX/Python `%`)."""
    r = torch.fmod(x, 1.0)
    return torch.where(r < 0, r + 1.0, r)


def rgb_to_hsv(img):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12),
                    torch.zeros_like(maxc))
    safe = torch.clamp(delta, min=1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = _mod1(h / 6.0)
    h = torch.where(delta == 0, torch.zeros_like(h), h)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(img):
    h, s, v = img[..., 0], img[..., 1], img[..., 2]
    fi = torch.floor(h * 6.0)
    f = h * 6.0 - fi
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    # sector i (h = 1.0 gives 6, which wraps to 0) picks (r, g, b) from
    # (v, q, p, t) as in colorsys.hsv_to_rgb
    i = (fi.to(torch.int32) % 6)[..., None, None]
    table = torch.stack([torch.stack(c, -1) for c in (
        (v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))], -2)
    return torch.gather(table, -2, i.expand(*i.shape[:-2], 1, 3))[..., 0, :]


def _hue(x, shift):
    """x: (..., 3); shift broadcasts against x[..., 0]."""
    hsv = rgb_to_hsv(x)
    return hsv_to_rgb(torch.stack([_mod1(hsv[..., 0] + shift), hsv[..., 1], hsv[..., 2]], -1))


def photometric_reference(images, order, params):
    """Plain PyTorch version of the kernel, same signature and semantics.

    images (B, H, W, 3) float32 in [0, 1]; order (B, 4) int32 permutation of
    the ops [brightness, contrast, saturation, hue]; params (B, 5) float32
    [fb, fc, fs, hue_shift, gray_gate]. A hue shift of exactly 0 skips the
    HSV round trip, so identity factors return the input unchanged."""
    B, H, W, C = images.shape
    x = images.reshape(B, H * W, C)
    fb, fc, fs, fh, gate = (params[:, k].reshape(B, 1, 1) for k in range(5))
    ops = order.long().clamp(0, 3)
    for j in range(4):
        op = ops[:, j].reshape(B, 1, 1)
        mean = _gray(x).mean(dim=1).reshape(B, 1, 1)
        y = torch.where(op == 0, torch.clamp(fb * x, 0.0, 1.0), x)
        y = torch.where(op == 1, _blend(x, mean, fc), y)
        y = torch.where(op == 2, _blend(x, _gray(x)[..., None], fs), y)
        hue_on = (op == 3) & (fh != 0)
        y = torch.where(hue_on, _hue(x, fh[..., 0]), y)
        x = y
    g = _gray(x)[..., None].expand_as(x)
    x = torch.where(gate > 0.5, g, x)
    return x.reshape(B, H, W, C)


def fused_photometric(images, order, params):
    """(B, H, W, 3) float32 images in [0, 1] -> jittered, gray-gated images.

    CUDA tensors go through the hand-written kernel, CPU tensors through
    `photometric_reference`. Counts kernel launches in the counter
    `photometric.launches` (`utils/trace.py`)."""
    if images.device.type == "cpu":
        return photometric_reference(images, order, params)
    if images.device.type != "cuda":
        raise ValueError(f"fused_photometric: unsupported device {images.device}")
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be (B, H, W, 3), got {tuple(images.shape)}")
    B, H, W, _ = images.shape
    for name, t, dtype, shape in (("images", images, torch.float32, (B, H, W, 3)),
                                  ("order", order, torch.int32, (B, 4)),
                                  ("params", params, torch.float32, (B, 5))):
        if t.device != images.device:
            raise ValueError(f"{name} is on {t.device}, images on {images.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(images)
    if B == 0 or H * W == 0:
        return out
    # the library launches on the current device: make it the images' (a
    # rank's tensors on cuda:k while another device is current)
    with torch.cuda.device(images.device):
        err = _library().ssv_fused_photometric(
            ctypes.c_void_p(images.data_ptr()), ctypes.c_void_p(order.data_ptr()),
            ctypes.c_void_p(params.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            B, H * W, ctypes.c_void_p(torch.cuda.current_stream(images.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"fused_photometric kernel launch failed: CUDA error {err}")
    trace.count("photometric.launches")
    return out


def _library():
    from .build import load
    lib = load("photometric")
    if lib.ssv_fused_photometric.argtypes is None:
        lib.ssv_fused_photometric.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.ssv_fused_photometric.restype = ctypes.c_int
    return lib


def sample_photometric_params(n: int, jitter_cfg: dict, gray_p: float,
                              apply_prob: float | None,
                              generator: torch.Generator, device):
    """Per-image (order (n, 4) int32, params (n, 5) float32) for the kernel.

    Factors are uniform in [max(0, 1 - x), 1 + x] (hue in [-h, h]); the op
    order is a uniform random permutation; with the RandomApply gate off, or
    an op's strength 0, the op gets its identity factor (1, or hue 0)."""
    brightness = float(jitter_cfg.get("brightness", 0.0))
    contrast = float(jitter_cfg.get("contrast", 0.0))
    saturation = float(jitter_cfg.get("saturation", 0.0))
    hue = float(jitter_cfg.get("hue", 0.0))
    u = torch.rand(n, 6, generator=generator, device=device)
    if apply_prob is not None:
        gate = u[:, 0] < apply_prob
    else:
        gate = torch.ones(n, dtype=torch.bool, device=device)

    def factor(col, lo, hi, strength, identity):
        val = lo + (hi - lo) * u[:, col]
        if strength <= 0:
            return torch.full_like(val, identity)
        return torch.where(gate, val, torch.full_like(val, identity))

    fb = factor(1, max(0.0, 1 - brightness), 1 + brightness, brightness, 1.0)
    fc = factor(2, max(0.0, 1 - contrast), 1 + contrast, contrast, 1.0)
    fs = factor(3, max(0.0, 1 - saturation), 1 + saturation, saturation, 1.0)
    fh = factor(4, -hue, hue, hue, 0.0)
    gray = (u[:, 5] < gray_p).float()
    order = torch.argsort(torch.rand(n, 4, generator=generator, device=device),
                          dim=1).to(torch.int32)
    params = torch.stack([fb, fc, fs, fh, gray], dim=1).contiguous()
    return order.contiguous(), params
