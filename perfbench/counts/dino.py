"""FLOPs an image of a DINO training step on the ViT: the student's
forward and backward, counted as 3 x forward, over every crop of both base
views (2 x (global + local crops)), and the teacher's forward alone, 1 x,
over the global crops; each crop through the encoder (`counts/vit.py`) and
the head on its CLS output (dense d -> h, h -> h, h -> h, then the
weight-normed h -> K: 2 (d h + 2 h^2 + h K)). The loss's softmaxes, the
L2 norms and the weight norm count nothing.

At the shipped widths (d 384, e 192, f 768, p 4, 6 layers, h 512, K 1,024;
2 global 32x32 crops of 64 patches and 6 local 8x8 crops of 4 patches a
base view): a global crop's forward 858,518,528 FLOPs (embedding
11,980,800, six layers of 140,674,560, the head 2,490,368), a local
crop's 65,573,888 (921,600, six of 10,360,320, 2,490,368); an image
3 x (4 x 858,518,528 + 12 x 65,573,888) + 4 x 858,518,528 =
16,096,956,416 FLOPs, 1.030 TFLOP a step of 64 images.
"""

from __future__ import annotations

from .vit import crop_flops


def flops_per_image(cfg: dict, hw, batch: int) -> float:
    enc, head, mc = cfg["encoder"], cfg["proj_head"], cfg["data"]["multicrop_config"]
    d, h, k = int(enc["hidden_dim"]), int(head["hidden_dim"]), int(head["proj_dim"])
    heads = 2 * (d * h + 2 * h * h + h * k)
    glob = crop_flops(enc, int(enc["num_global_patches"])) + heads
    loc = crop_flops(enc, int(enc["num_local_patches"])) + heads
    crops_g, crops_l = 2 * int(mc["num_global_views"]), 2 * int(mc["num_local_views"])
    return 3 * (crops_g * glob + crops_l * loc) + crops_g * glob
