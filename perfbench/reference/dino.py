"""DINO (arXiv:2104.14294) as the shipped recipe trains it (the reference
repository's `models/dino.py` and `configs/dino.yaml`) on its ViT
(`reference/vit.py`), written from the paper and the repository's
description in plain PyTorch, float32:

  * weights (`specs`): a student tower `model.*` and a teacher tower
    `teacher.*`, each the ViT encoder and the head (three dense layers of
    `proj_head.hidden_dim`, the exact GELU between them, the output
    L2-normalised, then the weight-normed `fc_out`, row j of its weight
    g_j v_j / ||v_j||, to `proj_dim`), drawn on their own; the center
    `center.value`, a (1, proj_dim) state buffer drawn normal with std 1
    (`center_init: randn`). Only the student trains;
  * views (`views`): two base views of the batch by the shipped train
    transform (`augment.train_view` of `multicrop_config.train_transforms`),
    then of each `num_global_views` crops at `global_size` with scale
    (s, 1) and `num_local_views` crops at `local_size` with scale (0.08,
    s), s the `scale_threshold`, each crop its own box (`augment.crop_box`),
    resampled with antialiased bicubic weights. Draws in this order: both
    base views, the global crops of the first and of the second, then
    their local crops, each group's boxes one call of each kind
    (areas, ratios, offsets) over the group's crops, image-major;
  * loss: the teacher runs on the global crops without gradient, the
    student on all of them; 0.5 (t1 against s2) + 0.5 (t2 against s1),
    t_i the teacher's outputs of base view i's global crops and s_i the
    student's of all of view i's crops, each the mean over the batch and
    the student's crops of the cross-entropy of softmax((t - center) /
    tau_t) against log_softmax(s / tau_s) for each of the teacher's crops,
    summed over them; tau_s `student_temp`, tau_t the first epoch's
    teacher temperature (`teacher_temp_lower`; the checked steps are the
    first epoch's), the center as it was before the step; float32;
  * update: Adam (`common.adam`) with the decay decoupled (`adamw`), each
    gradient element clamped to +-`gradient_clip`, lr from the warm-up
    cosine (`common.lr_at`), the decay on a cosine from
    `weight_decay_lower` to `weight_decay_upper` over the epochs, taken at
    the step's epoch;
  * after the update: center = m center + (1 - m) the mean of the
    teacher's outputs of the step (`center_momentum` m).

Departures from the reference repository: the crops are resampled with
Keys' cubic convolution (a = -0.5), widened and renormalised when they
shrink (the formula of jax.image.scale_and_translate), where the
repository resamples with PIL's bicubic; the teacher's EMA, which the
recipe takes once an epoch, is left out, since no checked step reaches an
epoch's end. Nothing here imports the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import vit
from .augment import crop_box, train_view
from .common import adam, cosine_ramp, l2_normalize, lr_at

HEAD_LAYERS = 3
KEYS_A = -0.5


def head_specs(prefix: str, in_dim: int, hidden: int, out: int) -> list:
    dims = [in_dim] + [hidden] * HEAD_LAYERS
    specs = []
    for i in range(HEAD_LAYERS):
        specs += [(f"{prefix}mlp.fc.{i}.weight", (dims[i + 1], dims[i]), "linear"),
                  (f"{prefix}mlp.fc.{i}.bias", (dims[i + 1],), "zero")]
    return specs + [(f"{prefix}fc_out.v", (out, hidden), "linear"),
                    (f"{prefix}fc_out.g", (out,), "one"),
                    (f"{prefix}fc_out.bias", (out,), "zero")]


def specs(cfg: dict) -> list:
    enc, head = cfg["encoder"], cfg["proj_head"]
    d, k = int(enc["hidden_dim"]), int(head["proj_dim"])
    out = []
    for side in ("model", "teacher"):
        out += vit.specs(f"{side}.encoder.", enc)
        out += head_specs(f"{side}.proj.", d, int(head["hidden_dim"]), k)
    return out + [("center.value", (1, k), "normal", "buffer")]


def trainable(names) -> list[str]:
    return [n for n in names if n.startswith("model.")]


# --------------------------------------------------------------------------
# the views
# --------------------------------------------------------------------------

def keys_cubic(x):
    """Keys' cubic convolution kernel at |x|: (a + 2)|x|^3 - (a + 3)|x|^2 + 1
    below 1, a|x|^3 - 5a|x|^2 + 8a|x| - 4a below 2, else 0."""
    a, x = KEYS_A, torch.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a
    return torch.where(x < 1.0, near, torch.where(x < 2.0, far, torch.zeros_like(x)))


def cubic_weights(n_in: int, n_out: int, start, length):
    """(B, n_out, n_in) weights that resample the span [start, start +
    length) of each row to n_out samples: sample o at source position (o +
    0.5) length / n_out + start - 0.5, the kernel widened by length / n_out
    where that exceeds 1, each sample's weights renormalised to sum 1, and
    none for a sample outside the row."""
    stride = (length / n_out)[:, None, None]
    widen = torch.clamp(stride, min=1.0)
    dev = start.device
    pos = ((torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5)[None, :, None] * stride
           + start[:, None, None] - 0.5)
    src = torch.arange(n_in, dtype=torch.float32, device=dev)[None, None, :]
    w = keys_cubic((pos - src) / widen)
    total = w.sum(dim=2, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    return torch.where((pos >= -0.5) & (pos <= n_in - 0.5), w, torch.zeros_like(w))


def crops(generator, x, n: int, size, scale):
    """(B, H, W, 3) -> (B, n, *size, 3): n bicubic random resized crops of
    each image, one box each."""
    B, H, W, C = x.shape
    x = x.repeat_interleave(n, dim=0)
    m, dev = B * n, x.device
    u_area = torch.rand(m, 10, generator=generator, device=dev)
    u_ratio = torch.rand(m, 10, generator=generator, device=dev)
    u_ij = torch.rand(m, 2, generator=generator, device=dev)
    i, j, h, w = crop_box((H, W), tuple(scale), (3.0 / 4.0, 4.0 / 3.0), u_area, u_ratio,
                          u_ij[:, 0], u_ij[:, 1])
    y = torch.einsum("boh,bhwc->bowc", cubic_weights(H, size[0], i, h), x)
    y = torch.einsum("bpw,bowc->bopc", cubic_weights(W, size[1], j, w), y)
    return y.reshape(B, n, *size, C)


def views(generator, raw_u8, cfg: dict) -> list:
    """[global crops of base view 1, of base view 2, local crops of 1, of
    2], each (B, crops, h, w, 3)."""
    mc = cfg["data"]["multicrop_config"]
    base = [train_view(generator, raw_u8, mc["train_transforms"]) for _ in range(2)]
    s = float(mc.get("scale_threshold", 0.3))
    groups = ((int(mc["num_global_views"]), tuple(mc["global_size"]), (s, 1.0)),
              (int(mc["num_local_views"]), tuple(mc["local_size"]), (0.08, s)))
    return [crops(generator, aug, n, size, scale) for n, size, scale in groups for aug in base]


# --------------------------------------------------------------------------
# the towers, the loss, the optimizer, the center
# --------------------------------------------------------------------------

def init_state(weights: dict, cfg: dict) -> dict:
    return {"center": weights["center.value"].detach().clone()}


def tower(params: dict, side: str, x, cfg: dict, cast):
    """(N, h, w, 3) crops -> (N, proj_dim) head outputs."""
    h = vit.forward(params, f"{side}.encoder.", x, cfg["encoder"], cast)
    at = f"{side}.proj."
    for i in range(HEAD_LAYERS):
        h = vit.dense(h, params[f"{at}mlp.fc.{i}.weight"], params[f"{at}mlp.fc.{i}.bias"], cast)
        if i < HEAD_LAYERS - 1:
            h = cast(F.gelu(h))
    v = params[f"{at}fc_out.v"]
    g = params[f"{at}fc_out.g"] / torch.clamp(torch.linalg.vector_norm(v, dim=1), min=1e-12)
    return l2_normalize(h) @ (v * g[:, None]).T + params[f"{at}fc_out.bias"]


def towers(params: dict, side: str, group, cfg: dict, cast):
    """A group's (B, V, ...) crops through one tower: (B, V, proj_dim)."""
    return tower(params, side, group.flatten(0, 1), cfg, cast).reshape(*group.shape[:2], -1)


def cross_entropy(teacher, student, center, temp_t: float, temp_s: float):
    logp = torch.log_softmax(student / temp_s, dim=-1)
    total = 0.0
    for t in range(teacher.shape[1]):
        p = torch.softmax((teacher[:, t] - center) / temp_t, dim=-1)
        total = total - (p[:, None, :] * logp).sum(dim=-1).mean()
    return total


def loss(params: dict, views: list, cfg: dict, cast, state: dict):
    g1, g2, l1, l2 = views
    with torch.no_grad():
        t1, t2 = (towers(params, "teacher", g, cfg, cast) for g in (g1, g2))
    state["teacher_mean"] = torch.cat([t1.flatten(0, 1), t2.flatten(0, 1)]).mean(0, keepdim=True)
    s1, s2 = (torch.cat([towers(params, "model", g, cfg, cast),
                         towers(params, "model", loc, cfg, cast)], dim=1)
              for g, loc in ((g1, l1), (g2, l2)))
    temp_t = float(cfg.get("teacher_temp_lower", 0.04))
    temp_s = float(cfg.get("student_temp", 0.1))
    return (0.5 * cross_entropy(t1, s2, state["center"], temp_t, temp_s)
            + 0.5 * cross_entropy(t2, s1, state["center"], temp_t, temp_s))


def update(params: dict, grads: dict, opt_state: dict, step: int, cfg: dict,
           steps_per_epoch: int) -> dict:
    opt = cfg["optimizer"]
    wd = cosine_ramp(step // steps_per_epoch, int(cfg["epochs"]),
                     float(cfg.get("weight_decay_lower", 0.04)),
                     float(cfg.get("weight_decay_upper", 0.4)))
    return adam(params, grads, opt_state, step, lr_at(step, cfg, steps_per_epoch), wd,
                decoupled=opt["name"] == "adamw", clip=float(cfg["gradient_clip"]),
                eps=float(opt.get("epsilon", 1e-8)))


@torch.no_grad()
def after_update(params: dict, step: int, cfg: dict, steps_per_epoch: int, state: dict) -> None:
    m = float(cfg.get("center_momentum", 0.9))
    state["center"] = m * state["center"] + (1.0 - m) * state["teacher_mean"]
