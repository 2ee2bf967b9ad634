"""Forward FLOPs of the shipped DINO ViT (`reference/vit.py`) on one crop
of n patches, T = n + 1 tokens with the CLS, from the configuration's
`encoder` block (hidden d, position width e, feed-forward f, patch p, L
layers); 2 FLOPs a multiply-add, the dense layers and the two attention
products; LayerNorm, GELU, softmax and the sums count nothing:

  * the embedding: one dense layer over [pixels || position], 2 T (3 p^2 +
    e) d (the port projects the CLS token and the position table once for
    the batch, and so does less; the count is the model's);
  * a layer: Q, K and V 3 x 2 T d^2 (no output projection), the scores and
    the product with V 2 x 2 T^2 d (over all heads), the feed-forward
    2 x 2 T d f.
"""

from __future__ import annotations


def crop_flops(enc: dict, patches: int) -> int:
    d, e, f = int(enc["hidden_dim"]), int(enc["embedding_dim"]), int(enc["intermediate_dim"])
    t = patches + 1
    embed = 2 * t * (3 * int(enc["patch_size"]) ** 2 + e) * d
    layer = 3 * 2 * t * d * d + 2 * 2 * t * t * d + 2 * 2 * t * d * f
    return embed + int(enc["num_encoder_layers"]) * layer
