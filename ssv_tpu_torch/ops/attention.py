"""The ViT's attention core: softmax(q k^T / sqrt(d), keys masked) v.

`attention(q, k, v, valid_len, return_attn)` takes q, k and v as
(b, n, h, d) tensors in the compute dtype (views of the Linear outputs
(b, n, h * d), or of the fused QKV product's (b, n, 3, h, d)) and returns
the (b, n, h * d) output in that dtype, with the (b, h, n, n) float32
probabilities where `return_attn` asks for them (else None). Keys at or
past `valid_len` are masked with NEG_MASK, as `seq_pad_multiple`'s padding
is.

On a CUDA tensor it launches the hand-written kernels in csrc/attention.cu
(they replace no TPU kernel: the JAX package leaves attention to XLA):
forward, one kernel that writes the output and, when autograd needs it,
each row's float32 log-sum-exp; backward, one kernel that recomputes the
scores and writes dq, dk and dv. Autograd keeps q, k, v and the log-sum-exp,
not the float32 scores or probabilities. Counts kernel launches in the
counter `attention.launches` (`utils/trace.py`). A CUDA tensor the kernels
do not take (not bf16, d not 64, n over MAX_TOKENS, q, k and v of other
shapes or strides, a row stride not a multiple of 8 elements) raises.

On a CPU tensor it runs `attention_reference`, the composition the kernels
replace, as the ViT ran it before: q and k cast up to float32, their
product, the scale and mask, the float32 softmax, the probabilities cast
down for probs @ v.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils import trace

NEG_MASK = -1e9
HEAD_DIM = 64      # the only head width the kernels take (csrc/attention.cu kD)
MAX_TOKENS = 128   # the longest sequence one CTA holds
ALIGN = 8          # elements (16 bytes of bf16) a row stride must be a multiple of


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        valid_len: int | None = None):
    """The plain composition: ((b, n, h * d) output in q's dtype, (b, h, n, n)
    float32 probabilities)."""
    b, n, h, d = q.shape
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))          # (b, h, n, d)
    scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(d)
    if valid_len is not None and valid_len < n:
        keep = torch.arange(n, device=q.device) < valid_len
        scores = scores.masked_fill(~keep, NEG_MASK)
    probs = torch.softmax(scores, dim=-1)
    out = (probs.to(q.dtype) @ v).transpose(1, 2).reshape(b, n, h * d)
    return out, probs


def attention_bytes(q: torch.Tensor, backward: bool = True) -> int:
    """The least bytes a call moves through the kernels: q, k and v read and
    the output written forward; q, k, v and the output's gradient read and
    dq, dk and dv written backward (the log-sum-exp's 4 bytes a row left
    out)."""
    t = q.numel() * q.element_size()
    return 4 * t + (7 * t if backward else 0)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              valid_len: int | None = None, return_attn: bool = False):
    """(module docstring) -> (output, probabilities or None)."""
    if q.device.type == "cpu":
        out, probs = attention_reference(q, k, v, valid_len)
        return out, probs if return_attn else None
    _check(q, k, v, valid_len)
    n = q.shape[1]
    valid = n if valid_len is None else min(int(valid_len), n)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Attention.apply(q, k, v, valid, return_attn)
    out, _, probs = _forward(q, k, v, valid, with_lse=False, with_probs=return_attn)
    return out, probs


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, valid, return_attn):
        out, lse, probs = _forward(q, k, v, valid, with_lse=True, with_probs=return_attn)
        ctx.save_for_backward(q, k, v, lse)
        ctx.valid = valid
        if probs is not None:
            ctx.mark_non_differentiable(probs)
        return out, probs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad, _grad_probs):
        q, k, v, lse = ctx.saved_tensors
        g = grad.contiguous()
        b, n, h, d = q.shape
        if g.dtype != q.dtype or tuple(g.shape) != (b, n, h * d) or g.data_ptr() % 16:
            raise ValueError(f"attention backward: gradient {g.dtype} {tuple(g.shape)} for "
                             f"{q.dtype} {(b, n, h * d)}")
        dq, dk, dv = _backward(q, k, v, g, lse, ctx.valid)
        return dq, dk, dv, None, None


def _check(q, k, v, valid_len: int | None) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    _check_layout(q, k, v, valid_len)


def _check_layout(q, k, v, valid_len: int | None) -> None:
    """What the kernels take of q, k, v and `valid_len`, on any device."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention: q, k and v must be (b, n, h, d) of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if {q.dtype, k.dtype, v.dtype} != {torch.bfloat16}:
        raise ValueError(f"attention: q, k and v must be bf16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("attention: q, k and v must be on one device")
    b, n, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"attention: head width must be {HEAD_DIM}, got {d}")
    if not 1 <= n <= MAX_TOKENS:
        raise ValueError(f"attention: sequence length must be 1 to {MAX_TOKENS}, got {n}")
    if valid_len is not None and valid_len < 1:
        raise ValueError(f"attention: valid_len must be at least 1, got {valid_len}")
    strides = q.stride()
    if k.stride() != strides or v.stride() != strides:
        raise ValueError(f"attention: q, k and v must share strides, got {q.stride()}, "
                         f"{k.stride()}, {v.stride()}")
    if strides[3] != 1 or strides[2] != d or strides[1] % ALIGN or strides[0] % ALIGN:
        raise ValueError(f"attention: strides must be (sb, sn, {d}, 1) with sb and sn "
                         f"multiples of {ALIGN}, got {strides}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("attention: q, k and v must be 16-byte aligned")


def _stream(x) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _ptr(t) -> ctypes.c_void_p | None:
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _launched(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"attention kernel {name} launch failed: CUDA error {err}")
    trace.count("attention.launches")


def _forward(q, k, v, valid: int, with_lse: bool, with_probs: bool):
    """(output (b, n, h * d), log-sum-exp (b, h, n) float32 or None,
    probabilities (b, h, n, n) float32 or None)."""
    b, n, h, d = q.shape
    out = torch.empty((b, n, h * d), dtype=q.dtype, device=q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, n), **f32) if with_lse else None
    probs = torch.empty((b, h, n, n), **f32) if with_probs else None
    if b:
        with torch.cuda.device(q.device):
            _launched(_library().ssv_attn_fwd(
                _ptr(q), _ptr(k), _ptr(v), q.stride(0), q.stride(1), b, h, n, valid,
                _ptr(out), _ptr(lse), _ptr(probs), _stream(q)), "vit_attn_fwd")
    return out, lse, probs


def _backward(q, k, v, g, lse, valid: int):
    b, n, h, d = q.shape
    dq, dk, dv = (torch.empty((b, n, h, d), dtype=q.dtype, device=q.device) for _ in range(3))
    if b:
        with torch.cuda.device(q.device):
            _launched(_library().ssv_attn_bwd(
                _ptr(q), _ptr(k), _ptr(v), q.stride(0), q.stride(1), _ptr(g), _ptr(lse),
                b, h, n, valid, _ptr(dq), _ptr(dk), _ptr(dv), _stream(q)), "vit_attn_bwd")
    return dq, dk, dv


@functools.cache
def _library():
    from .build import load
    lib = load("attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (
            ("ssv_attn_fwd", [p, p, p, ll, i, i, i, i, i, p, p, p, p]),
            ("ssv_attn_bwd", [p, p, p, ll, i, p, p, i, i, i, i, p, p, p, p])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return lib
