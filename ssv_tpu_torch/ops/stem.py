"""The ResNet stem's tail, `maxpool3x3/s2/p1(relu(bn1(x)))`, fused.

`stem_tail(x, bn)` takes the stem conv's output `x`, (N, C, H, W)
channels-last, and the stem's BatchNorm2d `bn` (`models/resnet.py`'s, with
flax's running variance). On a CUDA tensor it launches the hand-written
kernels in csrc/stem.cu (they replace no TPU kernel: the JAX package leaves
this tail to XLA): forward, a statistics pass and a merge (training; eval
mode merges the running statistics alone), then one pass that normalises,
applies the ReLU and max-pools, writing the pooled output and, when autograd
needs it, a 1-byte window offset a pooled value; backward, a reduce, a
merge and an elementwise pass. Autograd keeps the conv output, the offsets
and the statistics, not the BN's output or int64 indices. Counts kernel
launches in the counter `stem.launches` (`utils/trace.py`).

On a CPU tensor, and where a training BN's statistics span the data group
(`bn.sync` and more than one data rank: the global statistics and their
all-reduce, `_FlaxRunningVar._global_forward`), it runs `stem_reference`,
the composition the kernels replace: `bn`, an in-place ReLU and
`MaxPool2d(3, 2, 1)`. A CUDA tensor the kernels do not take (not bf16 or
float32, not channels-last, C not a multiple of 8 or over 2,048) raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..parallel.mesh import data_size
from ..utils import trace

THREADS = 256            # a CTA's threads at most (csrc/stem.cu kThreads)
STATS, REDUCE, ELEMT = 0, 1, 2   # the kernels whose grids are one full wave
SMEM_BUDGET = 48 * 1024  # the normalise-pool pass's shared memory a CTA, at most
SMEM_MAX = 227 * 1024    # the card's most for one CTA
BANDS = (8, 4, 2, 1)     # output rows a CTA of that pass may take, most first


def stem_reference(x: torch.Tensor, bn) -> torch.Tensor:
    """The plain composition: `bn`, in-place ReLU, max-pool 3x3/s2/p1."""
    return F.max_pool2d(F.relu(bn(x), inplace=True), 3, 2, 1)


# the kernels' arithmetic in plain PyTorch, step by step, for the checks on
# the card (tests/test_torch_stem.py, chip_smoke.py)

def plain_stats(x: torch.Tensor, bn) -> torch.Tensor:
    """(4, C) float32 [mean, rstd, scale, shift] as the kernels define
    them: the batch's mean and biased variance in training, the running
    statistics in eval; scale = weight * rstd, shift = bias - mean * scale."""
    if bn.training:
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
    else:
        mean, var = bn.running_mean, bn.running_var
    rstd = 1.0 / torch.sqrt(var + bn.eps)
    scale = bn.weight.detach() * rstd
    return torch.stack([mean, rstd, scale, bn.bias.detach() - mean * scale])


def plain_tail(x: torch.Tensor, stats: torch.Tensor):
    """From the statistics: y = relu(round(x * scale + shift)) in x's type
    (the multiply and the add each rounded to float32), then aten's max-pool
    with its int64 flat indices ih * W + iw. Returns (y, out, indices)."""
    scale, shift = (stats[k].reshape(1, -1, 1, 1) for k in (2, 3))
    y = torch.relu((x.float() * scale + shift).to(x.dtype))
    out, ind = F.max_pool2d(y, 3, 2, 1, return_indices=True)
    return y, out, ind


def plain_backward(x, y, gy, stats, weight, training: bool = True):
    """(dx, dweight, dbias): aten's max-pool and ReLU backward of `gy` from
    `y` (the gradient at each input position rounded to x's type), then
    BN's backward in float32 from the statistics, in aten's form."""
    yg = y.detach().requires_grad_()
    with torch.enable_grad():
        F.max_pool2d(yg, 3, 2, 1).backward(gy)
    dy = torch.where(y <= 0, torch.zeros_like(yg.grad), yg.grad).float()
    mean, rstd = (stats[k].reshape(1, -1, 1, 1) for k in (0, 1))
    n = dy.numel() // dy.shape[1]
    xm = x.float() - mean
    sum_dy, sum_dyx = dy.sum((0, 2, 3)), (dy * xm).sum((0, 2, 3))
    k0 = (sum_dy / n).reshape(1, -1, 1, 1) if training else 0.0
    k1 = rstd * rstd * sum_dyx.reshape(1, -1, 1, 1) / n if training else 0.0
    dx = ((dy - k0 - xm * k1) * (weight.detach().reshape(1, -1, 1, 1) * rstd)).to(x.dtype)
    return dx, sum_dyx * rstd.flatten(), sum_dy


def flat_indices(idx: torch.Tensor, W: int) -> torch.Tensor:
    """The kernels' window offsets (N, C, Ho, Wo) uint8 as aten's flat
    indices ih * W + iw of the input (bit 7, the ReLU's flag, dropped)."""
    _, _, Ho, Wo = idx.shape
    off = (idx & 0x7F).long()
    oh = torch.arange(Ho, device=idx.device).reshape(1, 1, Ho, 1)
    ow = torch.arange(Wo, device=idx.device).reshape(1, 1, 1, Wo)
    return (2 * oh - 1 + off // 3) * W + (2 * ow - 1 + off % 3)


def stem_bytes(x: torch.Tensor, training: bool = True) -> int:
    """The least bytes a training step's forward and backward move through
    the kernels: x read by the statistics (training), x read and the pooled
    output and offsets written by the normalise-pool pass, x, the pooled
    gradient and the offsets read by the reduce and by the elementwise pass,
    which writes dx; the merges' few bytes a channel left out."""
    N, C, H, W, Ho, Wo = _geometry(x)
    xb, ob, ib = x.numel() * x.element_size(), N * C * Ho * Wo * x.element_size(), N * C * Ho * Wo
    return (xb if training else 0) + (xb + ob + ib) + (xb + ob + ib) + (2 * xb + ob + ib)


def stem_tail(x: torch.Tensor, bn) -> torch.Tensor:
    """(N, C, H, W) channels-last conv output -> (N, C, Ho, Wo) pooled,
    Ho = (H - 1) // 2 + 1 (module docstring)."""
    if x.device.type == "cpu" or (bn.training and bn.sync and data_size() > 1):
        return stem_reference(x, bn)
    _check(x, bn)
    if torch.is_grad_enabled() and (x.requires_grad or bn.weight.requires_grad
                                    or bn.bias.requires_grad):
        return _StemTail.apply(x, bn.weight, bn.bias, bn)
    out, _, _ = _forward(x, bn, with_idx=False)
    return out


class _StemTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, bn):
        out, idx, stats = _forward(x, bn, with_idx=True)
        ctx.save_for_backward(x, idx, stats, weight)
        ctx.training = bn.training
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, idx, stats, weight = ctx.saved_tensors
        gy = grad.contiguous(memory_format=torch.channels_last)
        if gy.dtype != x.dtype or gy.shape != idx.shape or gy.data_ptr() % 16:
            raise ValueError(f"stem_tail backward: gradient {gy.dtype} {tuple(gy.shape)} "
                             f"for {x.dtype} {tuple(idx.shape)}")
        dx, dw, db = _backward(x, gy, idx, stats, weight, ctx.training,
                               ctx.needs_input_grad[0])
        return dx, dw, db, None


def _check(x, bn) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"stem_tail: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"stem_tail: x must be a 4-d bf16 or float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    C = x.shape[1]
    if C % 8 or C > 8 * THREADS:
        raise ValueError(f"stem_tail: channels must be a multiple of 8 up to {8 * THREADS}, "
                         f"got {C}")
    if not x.is_contiguous(memory_format=torch.channels_last) or x.data_ptr() % 16:
        raise ValueError("stem_tail: x must be channels-last contiguous and 16-byte aligned")
    for name in ("weight", "bias", "running_mean", "running_var"):
        t = getattr(bn, name)
        if (t is None or t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != (C,) or not t.is_contiguous()):
            raise ValueError(f"stem_tail: bn.{name} must be float32 ({C},) on {x.device}")
    if bn.num_batches_tracked is None or bn.num_batches_tracked.device != x.device:
        raise ValueError(f"stem_tail: bn.num_batches_tracked must be on {x.device}")
    if bn.momentum is None:
        raise ValueError("stem_tail: bn.momentum None (a cumulative average) is not taken")


def _geometry(x):
    N, C, H, W = x.shape
    return N, C, H, W, (H - 1) // 2 + 1, (W - 1) // 2 + 1


def _split(total: int, lanes: int, ctas: int) -> tuple[int, int]:
    """(CTAs, items a CTA) for a pass over `total` items in fixed ranges:
    at most `ctas` CTAs, at least one item a lane."""
    want = max(1, min(ctas, -(-total // lanes)))
    per = -(-total // want)
    return -(-total // per), per


def _grid(kernel: int, x, total: int) -> tuple[int, int]:
    """`_split` for `kernel` over `total` items of x: as many CTAs as the
    card holds at once (a fixed partition for a card, so the sums' order
    is too)."""
    groups = x.shape[1] // 8
    index = torch.cuda.current_device() if x.device.index is None else x.device.index
    return _split(total, THREADS // groups,
                  _wave(kernel, int(x.dtype == torch.bfloat16), groups, index))


@functools.cache
def _wave(kernel: int, bf16: int, groups: int, index: int) -> int:
    """CTAs of `kernel` the card `index` holds at once."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _library().ssv_stem_resident(kernel, bf16, THREADS // groups * groups,
                                           ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"stem kernel {kernel}: occupancy query failed (CUDA error {err}, "
                           f"{blocks.value} CTAs an SM)")
    return blocks.value * torch.cuda.get_device_properties(index).multi_processor_count


def _band(H: int, W: int, Ho: int, G: int, itemsize: int) -> tuple[int, int]:
    """(R output rows, gc channel groups) a CTA of the normalise-pool pass
    takes: the most rows, then the most groups, whose min(H, 2R + 1) input
    rows fit SMEM_BUDGET (past it, one row band of as many groups as fit,
    up to SMEM_MAX; csrc/stem.cu sizes its shared memory alike)."""
    def smem(R, gc):
        return min(H, 2 * R + 1) * W * gc * 8 * itemsize
    gc = min(G, THREADS)
    for R in BANDS:
        if smem(R, gc) <= SMEM_BUDGET:
            return min(R, Ho), gc
    gc = max(1, min(gc, SMEM_BUDGET // smem(1, 1)))
    if smem(1, gc) > SMEM_MAX:
        raise ValueError(f"stem_tail: a row of width {W} does not fit a CTA's shared memory")
    return 1, gc


def _stream(x) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _launched(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"stem kernel {name} launch failed: CUDA error {err}")
    trace.count("stem.launches")


def _forward(x, bn, with_idx: bool):
    """(pooled output, offsets or None, stats (4, C) float32: mean, rstd,
    scale, shift); updates bn's running statistics in training."""
    N, C, H, W, Ho, Wo = _geometry(x)
    bf16 = int(x.dtype == torch.bfloat16)
    out = torch.empty((N, Ho, Wo, C), dtype=x.dtype, device=x.device).permute(0, 3, 1, 2)
    idx = (torch.empty((N, Ho, Wo, C), dtype=torch.uint8, device=x.device).permute(0, 3, 1, 2)
           if with_idx else None)
    stats = torch.empty((4, C), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out, idx, stats
    lib, training = _library(), bool(bn.training)
    rows = N * H * W
    with torch.cuda.device(x.device):
        stream = _stream(x)
        if training:
            nblocks, rpb = _grid(STATS, x, rows)
            part = torch.empty((nblocks, 2, C), dtype=torch.float32, device=x.device)
            _launched(lib.ssv_stem_bn_fw_stats(_ptr(x), bf16, rows, C, nblocks, rpb,
                                               _ptr(part), stream), "stem_bn_fw_stats")
        else:
            nblocks, rpb, part = 0, 0, stats
        _launched(lib.ssv_stem_bn_fw_merge(
            _ptr(part), nblocks, rows, rpb, C, _ptr(bn.weight), _ptr(bn.bias),
            _ptr(bn.running_mean), _ptr(bn.running_var), _ptr(bn.num_batches_tracked),
            float(bn.momentum), float(bn.eps), int(training), _ptr(stats), stream),
            "stem_bn_fw_merge")
        R, gc = _band(H, W, Ho, C // 8, x.element_size())
        _launched(lib.ssv_stem_bn_fw_relu_max(
            _ptr(x), bf16, N, H, W, C, R, gc, _ptr(stats), _ptr(out),
            _ptr(idx) if with_idx else None, stream), "stem_bn_fw_relu_max")
    return out, idx, stats


def _backward(x, gy, idx, stats, weight, training: bool, need_dx: bool):
    N, C, H, W, _, _ = _geometry(x)
    bf16 = int(x.dtype == torch.bfloat16)
    rows = N * H * W
    dw = torch.empty_like(weight)
    db = torch.empty_like(weight)
    dx = torch.empty_like(x) if need_dx else None
    if x.numel() == 0:
        return dx, dw.zero_(), db.zero_()
    lib, blocks = _library(), gy.numel() // C   # the 2x2 input blocks a thread takes
    with torch.cuda.device(x.device):
        stream = _stream(x)
        nblocks, bpb = _grid(REDUCE, x, blocks)
        part = torch.empty((nblocks, 2, C), dtype=torch.float32, device=x.device)
        _launched(lib.ssv_stem_bn_bw_reduce(_ptr(x), _ptr(gy), _ptr(idx), bf16, N, H, W, C,
                                            nblocks, bpb, _ptr(stats), _ptr(part), stream),
                  "stem_bn_bw_reduce")
        coef = torch.empty((3, C), dtype=torch.float32, device=x.device)
        _launched(lib.ssv_stem_bn_bw_merge(_ptr(part), nblocks, rows, C, _ptr(stats),
                                           _ptr(weight), int(training), _ptr(dw), _ptr(db),
                                           _ptr(coef), stream), "stem_bn_bw_merge")
        if need_dx:
            ctas, _ = _grid(ELEMT, x, blocks)
            _launched(lib.ssv_stem_bn_bw_elemt(_ptr(x), _ptr(gy), _ptr(idx), bf16, N, H, W, C,
                                               ctas, _ptr(stats), _ptr(coef), _ptr(dx),
                                               stream), "stem_bn_bw_elemt")
    return dx, dw, db


@functools.cache
def _library():
    from .build import load
    lib = load("stem")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    for name, args in (
            ("ssv_stem_resident", [i, i, i, p]),
            ("ssv_stem_bn_fw_stats", [p, i, ll, i, i, ll, p, p]),
            ("ssv_stem_bn_fw_merge", [p, i, ll, ll, i, p, p, p, p, p, f, f, i, p, p]),
            ("ssv_stem_bn_fw_relu_max", [p, i, i, i, i, i, i, i, p, p, p, p]),
            ("ssv_stem_bn_bw_reduce", [p, p, p, i, i, i, i, i, i, ll, p, p, p]),
            ("ssv_stem_bn_bw_merge", [p, i, ll, i, p, p, i, p, p, p, p]),
            ("ssv_stem_bn_bw_elemt", [p, p, p, i, i, i, i, i, i, p, p, p, p])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return lib
