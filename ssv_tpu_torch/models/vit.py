"""The Vision Transformer with the reference's embedding (port of
ssv_tpu/models/vit.py).

What the JAX module does, kept here:
  * a learned CLS token in *patch-pixel* space is prepended, positional
    embeddings are *concatenated* on the feature axis and projected with the
    pixels by one Dense (`projection_fc`), with two tables, one for the
    global and one for the local patch count; another count raises;
  * that Dense is applied split: its pixel rows, ordered (c, py, px), are a
    p x p / stride-p convolution over the NHWC batch, and its position rows
    project the table, so no patch is extracted;
  * each sublayer's branch reads the raw input and LayerNorm(input) is
    added as the residual (the reference's quirk); Q/K/V have no bias;
    the feed-forward uses the exact GELU;
  * `seq_pad_multiple` pads the tokens with zeros and masks the padded keys
    with -1e9; `fuse_qkv` runs one (d, 3d) product over the same three
    weights; `return_attn` gives each layer's probabilities with padded rows
    and columns cut;
  * the output is the CLS token in float32;
  * each forward counts its tokens, padded, times the batch into the
    counter `vit.tokens` (`utils/trace.py`).

Numerics. The compute dtype is the module's `dtype` where it is given,
else the caller's autocast dtype (bf16 on the card), else float32; the
module casts explicitly with autocast off, as the flax module's `dtype`
does, since autocast's own choices differ from it (its `layer_norm`
returns float32, and the score product would be bf16):
  * LayerNorm computes in float32 and emits the compute dtype, so the
    residual stream is in the compute dtype;
  * the patch convolution, the CLS and position projections, Q/K/V, the
    feed-forward and probs @ V take and return the compute dtype; a Dense
    rounds its product before it adds the bias, as flax's does;
  * the attention scores are float32: q and k are cast up before their
    product, which with TF32 off is the JAX product of bf16 values with a
    float32 result; mask and softmax stay float32, the probabilities are
    cast down before probs @ V.

The attention core (q, k, v to the (b, n, hidden) output) is
`ops/attention.py`'s: in bf16, with heads `HEAD_DIM` wide, on sequences
of up to `MAX_TOKENS` tokens it goes to `attention`, which on the card launches the hand-written
kernels (the same arithmetic: bf16 products with float32 sums, float32
scores, mask, softmax and their gradients, the probabilities rounded to
bf16 for probs @ V) and on the CPU runs the composition above; in float32,
with heads of another width, or on a longer sequence, the module runs that
composition, `attention_reference`, itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import HEAD_DIM, MAX_TOKENS, attention, attention_reference
from ..utils import trace
from .heads import _lecun_trunc_normal_


def compute_dtype(device: torch.device) -> torch.dtype:
    """The autocast dtype where autocast is on for `device`, else float32."""
    if torch.is_autocast_enabled(device.type):
        return torch.get_autocast_dtype(device.type)
    return torch.float32


def _layer_norm(ln: nn.LayerNorm, x, dt):
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(dt)


def _linear(fc: nn.Linear, x, dt):
    y = F.linear(x, fc.weight.to(dt))
    return y if fc.bias is None else y + fc.bias.to(dt)


class SelfAttention(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int, fuse_qkv: bool = False):
        super().__init__()
        self.hidden_dim, self.num_heads, self.fuse_qkv = hidden_dim, num_heads, fuse_qkv
        self.ln = nn.LayerNorm(hidden_dim, eps=1e-6)
        self.query = nn.Linear(hidden_dim, hidden_dim, bias=False)
        self.key = nn.Linear(hidden_dim, hidden_dim, bias=False)
        self.value = nn.Linear(hidden_dim, hidden_dim, bias=False)

    def forward(self, x, dt, valid_len: int | None = None, return_attn: bool = False):
        """(output, the (b, h, n, n) float32 probabilities where
        `return_attn`, else None)."""
        b, n, _ = x.shape
        h = self.num_heads
        d = self.hidden_dim // h
        identity = _layer_norm(self.ln, x, dt)
        if self.fuse_qkv:
            w = torch.cat([self.query.weight, self.key.weight, self.value.weight]).to(dt)
            q, k, v = F.linear(x, w).reshape(b, n, 3, h, d).unbind(2)
        else:
            q, k, v = (_linear(fc, x, dt).reshape(b, n, h, d)
                       for fc in (self.query, self.key, self.value))
        if dt == torch.bfloat16 and n <= MAX_TOKENS and d == HEAD_DIM:
            out, probs = attention(q, k, v, valid_len, return_attn)
        else:
            out, probs = attention_reference(q, k, v, valid_len)
        return out + identity, probs if return_attn else None


class FeedForward(nn.Module):
    def __init__(self, hidden_dim: int, intermediate_dim: int):
        super().__init__()
        self.ln = nn.LayerNorm(hidden_dim, eps=1e-6)
        self.fc = nn.ModuleList([nn.Linear(hidden_dim, intermediate_dim),
                                 nn.Linear(intermediate_dim, hidden_dim)])

    def forward(self, x, dt):
        identity = _layer_norm(self.ln, x, dt)
        y = F.gelu(_linear(self.fc[0], x, dt))
        return _linear(self.fc[1], y, dt) + identity


class TransformerLayer(nn.Module):
    def __init__(self, hidden_dim: int, intermediate_dim: int, num_heads: int,
                 fuse_qkv: bool = False):
        super().__init__()
        self.attention = SelfAttention(hidden_dim, num_heads, fuse_qkv)
        self.feedfwd = FeedForward(hidden_dim, intermediate_dim)

    def forward(self, x, dt, valid_len: int | None = None, return_attn: bool = False):
        y, probs = self.attention(x, dt, valid_len, return_attn)
        return self.feedfwd(y, dt), probs


class TransformerEncoder(nn.Module):
    """Config keys follow configs/dino.yaml's `encoder` block. NHWC images
    in, the (B, hidden_dim) float32 CLS token out."""

    def __init__(self, hidden_dim: int, embedding_dim: int, intermediate_dim: int,
                 num_attention_heads: int, patch_size: int, num_encoder_layers: int,
                 num_global_patches: int, num_local_patches: int,
                 seq_pad_multiple: int = 0, fuse_qkv: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.hidden_dim, self.patch_size = hidden_dim, patch_size
        self.num_global_patches, self.num_local_patches = num_global_patches, num_local_patches
        self.seq_pad_multiple = seq_pad_multiple
        self.input_dim = 3 * patch_size * patch_size
        self.cls_embedding = nn.Parameter(torch.empty(1, 1, self.input_dim))
        self.pos_embedding_global = nn.Parameter(torch.empty(num_global_patches + 1,
                                                             embedding_dim))
        self.pos_embedding_local = nn.Parameter(torch.empty(num_local_patches + 1,
                                                            embedding_dim))
        # the reference's Dense over [pixels (c, py, px) || position]
        self.projection_fc = nn.Linear(self.input_dim + embedding_dim, hidden_dim)
        self.layers = nn.ModuleList(
            TransformerLayer(hidden_dim, intermediate_dim, num_attention_heads, fuse_qkv)
            for _ in range(num_encoder_layers))

    def embed(self, img, dt):
        """(B, H, W, 3) -> (B, n + 1, hidden) tokens in dtype `dt`: CLS then
        the patches in row-major order, each projected with its position."""
        b, h, w, _ = img.shape
        p = self.patch_size
        n = (h // p) * (w // p)
        if n == self.num_global_patches:
            pos = self.pos_embedding_global
        elif n == self.num_local_patches:
            pos = self.pos_embedding_local
        else:
            raise ValueError(f"Sequence of {n} patches matches neither global "
                             f"({self.num_global_patches}) nor local "
                             f"({self.num_local_patches})")
        weight = self.projection_fc.weight.to(dt)
        w_pix, w_pos = weight[:, :self.input_dim], weight[:, self.input_dim:]
        conv_w = w_pix.reshape(self.hidden_dim, 3, p, p)
        tok = F.conv2d(img.to(dt).permute(0, 3, 1, 2), conv_w, stride=p)
        tok = tok.flatten(2).transpose(1, 2)                        # (b, n, hidden)
        cls_tok = self.cls_embedding.reshape(1, self.input_dim).to(dt) @ w_pix.T
        x = torch.cat([cls_tok.expand(b, 1, self.hidden_dim), tok], dim=1)
        return x + (pos.to(dt) @ w_pos.T)[None] + self.projection_fc.bias.to(dt)

    def forward(self, img, return_attn: bool = False):
        dt = self.dtype or compute_dtype(img.device)
        with torch.autocast(img.device.type, enabled=False):
            x = self.embed(img, dt)
            seq = x.shape[1]
            valid_len = None
            if self.seq_pad_multiple:
                pad = (-seq) % self.seq_pad_multiple
                if pad:
                    x = F.pad(x, (0, 0, 0, pad))
                    valid_len = seq
            trace.count("vit.tokens", x.shape[0] * x.shape[1])
            attn = {}
            for i, layer in enumerate(self.layers):
                x, probs = layer(x, dt, valid_len, return_attn)
                if return_attn:
                    attn[f"layer_{i}"] = probs[..., :seq, :seq]
            cls_out = x[:, 0, :].float()
        return (cls_out, attn) if return_attn else cls_out

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """The flax initialisers: CLS and both position tables normal(1.0);
        `projection_fc` and every Dense lecun normal (truncated) with zero
        biases; LayerNorm 1 and 0."""
        for prm in (self.cls_embedding, self.pos_embedding_global, self.pos_embedding_local):
            nn.init.normal_(prm, 0.0, 1.0, generator=generator)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _lecun_trunc_normal_(m.weight, m.in_features, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
