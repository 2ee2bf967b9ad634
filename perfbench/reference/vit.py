"""The ViT encoder of the shipped DINO recipe (arXiv:2010.11929, as the
reference repository's `networks/vit.py` builds it), its forward in plain
PyTorch, float32, written from its equations:

  * each image is cut into p x p patches in row-major order, each patch the
    vector of its 3 p^2 pixels in (channel, row, column) order, the order
    of `nn.Unfold` over NCHW images;
  * a learned CLS token in that patch-pixel space goes first;
  * a position table, one for the global count of patches + 1 and one for
    the local count + 1, is concatenated to the pixels on the feature
    axis, and one dense layer (`projection_fc`) projects [pixels ||
    position] to the hidden width;
  * each layer is attention, then the feed-forward; each branch reads the
    raw input, and LayerNorm(input) (eps 1e-6) is added as the residual:
    attention is softmax(Q K^T / sqrt(d_head)) V over the heads, Q, K and
    V without bias and no output projection; the feed-forward is dense,
    the exact GELU, dense;
  * the output is the CLS token.

`cast` is applied where the recipe's bf16 run keeps a tensor in bf16: the
operands, the result and the bias of every dense layer (the pixel and
position projection, Q, K, V, the feed-forward's two layers), the GELU's
output, each LayerNorm's output and each sum with it (the residual
stream), and the probabilities and V of the product that weighs V. The
attention scores and their softmax stay float32 (the bf16 run computes
them from bf16 Q and K in float32), and so do the LayerNorm statistics.

Departures from the reference repository: the images come in NHWC, as the
benchmark makes them (the repository's are NCHW); the CLS token is
projected by the pixel rows of the same dense layer, the same arithmetic
as its concatenation. Nothing here imports the program under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def specs(prefix: str, enc: dict) -> list:
    """The encoder's weights under the program's names: the CLS token and
    both position tables drawn normal with std 1 (the program's
    initialiser), the dense layers `linear` with zero biases, the
    LayerNorms 1 and 0."""
    d, e, f = int(enc["hidden_dim"]), int(enc["embedding_dim"]), int(enc["intermediate_dim"])
    pixels = 3 * int(enc["patch_size"]) ** 2
    out = [(f"{prefix}cls_embedding", (1, 1, pixels), "normal"),
           (f"{prefix}pos_embedding_global", (int(enc["num_global_patches"]) + 1, e), "normal"),
           (f"{prefix}pos_embedding_local", (int(enc["num_local_patches"]) + 1, e), "normal"),
           (f"{prefix}projection_fc.weight", (d, pixels + e), "linear"),
           (f"{prefix}projection_fc.bias", (d,), "zero")]
    for i in range(int(enc["num_encoder_layers"])):
        at = f"{prefix}layers.{i}."
        out += [(f"{at}attention.ln.weight", (d,), "one"), (f"{at}attention.ln.bias", (d,), "zero")]
        out += [(f"{at}attention.{w}.weight", (d, d), "linear") for w in ("query", "key", "value")]
        out += [(f"{at}feedfwd.ln.weight", (d,), "one"), (f"{at}feedfwd.ln.bias", (d,), "zero"),
                (f"{at}feedfwd.fc.0.weight", (f, d), "linear"), (f"{at}feedfwd.fc.0.bias", (f,), "zero"),
                (f"{at}feedfwd.fc.1.weight", (d, f), "linear"), (f"{at}feedfwd.fc.1.bias", (d,), "zero")]
    return out


def dense(x, weight, bias, cast):
    y = cast(cast(x) @ cast(weight).T)
    return y if bias is None else cast(y + cast(bias))


def layer_norm(params: dict, at: str, x, cast):
    return cast(F.layer_norm(x, x.shape[-1:], params[f"{at}weight"], params[f"{at}bias"], LN_EPS))


def patches(img, p: int):
    """(B, H, W, 3) -> (B, H/p x W/p, 3 p^2): row-major patches, each in
    (channel, row, column) order."""
    b, h, w, c = img.shape
    x = img.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (h // p) * (w // p), c * p * p)


def embed(params: dict, prefix: str, img, enc: dict, cast):
    """[CLS || patches] concatenated with the position table, projected."""
    x = patches(img, int(enc["patch_size"]))
    b, n, _ = x.shape
    if n == int(enc["num_global_patches"]):
        pos = params[f"{prefix}pos_embedding_global"]
    elif n == int(enc["num_local_patches"]):
        pos = params[f"{prefix}pos_embedding_local"]
    else:
        raise ValueError(f"{n} patches: neither the global nor the local count")
    cls_tok = params[f"{prefix}cls_embedding"].reshape(1, 1, -1).expand(b, 1, x.shape[-1])
    x = torch.cat([cls_tok, x], dim=1)
    x = torch.cat([x, pos[None].expand(b, n + 1, pos.shape[-1])], dim=-1)
    return dense(x, params[f"{prefix}projection_fc.weight"], params[f"{prefix}projection_fc.bias"],
                 cast)


def attention(params: dict, at: str, x, heads: int, cast):
    b, n, d = x.shape
    dh = d // heads
    q, k, v = (dense(x, params[f"{at}{w}.weight"], None, cast).reshape(b, n, heads, dh)
               .transpose(1, 2) for w in ("query", "key", "value"))
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
    probs = torch.softmax(scores, dim=-1)
    out = cast(cast(probs) @ v).transpose(1, 2).reshape(b, n, d)
    return cast(out + layer_norm(params, f"{at}ln.", x, cast))


def feedforward(params: dict, at: str, x, cast):
    y = cast(F.gelu(dense(x, params[f"{at}fc.0.weight"], params[f"{at}fc.0.bias"], cast)))
    y = dense(y, params[f"{at}fc.1.weight"], params[f"{at}fc.1.bias"], cast)
    return cast(y + layer_norm(params, f"{at}ln.", x, cast))


def forward(params: dict, prefix: str, img, enc: dict, cast):
    """(B, H, W, 3) images -> (B, hidden) CLS outputs."""
    x = embed(params, prefix, img, enc, cast)
    for i in range(int(enc["num_encoder_layers"])):
        at = f"{prefix}layers.{i}."
        x = attention(params, f"{at}attention.", x, int(enc["num_attention_heads"]), cast)
        x = feedforward(params, f"{at}feedfwd.", x, cast)
    return x[:, 0, :]
