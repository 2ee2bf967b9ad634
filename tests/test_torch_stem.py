"""The ResNet stem's fused tail (`ops/stem.py`, `csrc/stem.cu`).

On the CPU `stem_tail` is the composition it replaces, bit for bit: the
BN with flax's running variance, the in-place ReLU and MaxPool2d(3, 2, 1),
in its outputs, its three gradients and the running statistics after three
training steps, in eval mode, and inside the ResNet, whose `state_dict`
keeps its keys; the launch geometry is checked in plain Python. The tests
marked `card` hold the kernels to their plain versions on a CUDA card (and
bound how far bf16 parts from aten's composition) and skip without one;
run them there with

    python -m pytest tests/test_torch_stem.py -m card --noconftest
"""

import copy

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from ssv_tpu_torch.models import resnet as TR
from ssv_tpu_torch.ops import stem as S
from ssv_tpu_torch.utils import trace
from torch_helpers import card  # noqa: F401 (a fixture)

torch.set_num_threads(2)


def _bn(C, seed=0, device="cpu"):
    bn = TR.BatchNorm2d(C)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.3 * torch.randn(C, generator=g))
        bn.bias.copy_(0.2 * torch.randn(C, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(C, generator=g))
        bn.running_var.copy_(1 + 0.2 * torch.rand(C, generator=g))
    return bn.to(device)


def _x(N, C, H, W, dtype=torch.float32, seed=1, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = (0.5 + 1.5 * torch.randn(N, H, W, C, generator=g)).to(dtype)
    return x.to(device).permute(0, 3, 1, 2)  # channels-last (N, C, H, W)


def _old(x, bn):
    """The stem's tail as the ResNet ran it before the fused kernels."""
    return nn.MaxPool2d(3, stride=2, padding=1)(nn.ReLU(inplace=True)(bn(x)))


# --------------------------------------------------------------------------
# CPU: the composition, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 16, 8, 8), (3, 8, 7, 9), (2, 8, 12, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_training_steps_are_the_composition(shape, dtype):
    """Three training steps: outputs, the x, weight and bias gradients and
    the running statistics equal the old composition's bit for bit."""
    bn_new, bn_old = _bn(shape[1]), _bn(shape[1])
    for step in range(3):
        x = _x(*shape, dtype=dtype, seed=step)
        xa = x.detach().clone().requires_grad_()
        xb = x.detach().clone().requires_grad_()
        got, want = S.stem_tail(xa, bn_new), _old(xb, bn_old)
        assert got.dtype == want.dtype == dtype and got.shape == want.shape
        assert torch.equal(got, want)
        gy = torch.randn(got.shape, generator=torch.Generator().manual_seed(9 + step)).to(dtype)
        got.backward(gy)
        want.backward(gy)
        assert torch.equal(xa.grad, xb.grad)
        assert torch.equal(bn_new.weight.grad, bn_old.weight.grad)
        assert torch.equal(bn_new.bias.grad, bn_old.bias.grad)
    for k, v in bn_old.state_dict().items():
        assert torch.equal(bn_new.state_dict()[k], v), k
    assert int(bn_new.num_batches_tracked) == 3


def test_cpu_eval_uses_the_running_statistics():
    bn_new, bn_old = _bn(16).eval(), _bn(16).eval()
    x = _x(2, 16, 10, 10)
    with torch.no_grad():
        got, want = S.stem_tail(x, bn_new), _old(x, bn_old)
    assert torch.equal(got, want)
    assert torch.equal(bn_new.running_var, _bn(16).running_var)  # not updated
    assert int(bn_new.num_batches_tracked) == 0


def test_cpu_counts_no_launch():
    before = trace.counters.get("stem.launches", 0)
    S.stem_tail(_x(2, 8, 6, 6), _bn(8))
    assert trace.counters.get("stem.launches", 0) == before


@pytest.mark.parametrize("stem", ["cifar", "imagenet"])
def test_resnet_forward_is_the_old_one(stem):
    """The ResNet's features equal those of its old forward (conv1, bn1,
    ReLU, max-pool, the stages) from the same weights, in training, with
    the same running statistics after."""
    torch.manual_seed(0)
    net = TR.resnet18(reduce_bottom_conv=stem == "cifar")
    old = copy.deepcopy(net)
    x = torch.rand(2, 32, 32, 3)

    def old_features(m, x):
        y = _old(m.conv1(x.permute(0, 3, 1, 2)), m.bn1)
        for stage in range(m.num_stages):
            y = getattr(m, f"layer{stage + 1}")(y)
        return y.mean(dim=(2, 3)).float()

    assert torch.equal(net(x), old_features(old, x))
    for k, v in old.state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k


def test_resnet_state_dict_keeps_its_keys():
    """The stem keeps `bn1`'s parameters and buffers under their names; the
    stateless `relu` and `maxpool` modules are gone and held no state."""
    net = TR.resnet18(reduce_bottom_conv=True)
    keys = list(net.state_dict())
    assert keys[:6] == ["conv1.weight", "bn1.weight", "bn1.bias", "bn1.running_mean",
                        "bn1.running_var", "bn1.num_batches_tracked"]
    assert len(keys) == 120 and not any("relu" in k or "maxpool" in k for k in keys)
    assert not hasattr(net, "relu") and not hasattr(net, "maxpool")


@pytest.mark.parametrize("training", [True, False])
def test_cpu_plain_versions_follow_the_composition(training):
    """The kernels' arithmetic in plain PyTorch (`plain_stats`,
    `plain_tail`, `plain_backward`, `flat_indices`) against the old
    composition in float32 on the CPU: the same output, indices and
    gradients up to float32 rounding."""
    bn, bn_old = _bn(8).train(training), _bn(8).train(training)
    g = torch.Generator().manual_seed(5)
    # a grid of 1/8: each window's max is the same position on both sides
    x = (torch.randint(-24, 24, (3, 9, 11, 8), generator=g) / 8).permute(0, 3, 1, 2)
    stats = S.plain_stats(x, bn)
    y, out, ind = S.plain_tail(x, stats)
    xb = x.clone().requires_grad_()
    want = _old(xb, bn_old)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    _, want_ind = F.max_pool2d(torch.relu(_bn(8).train(training)(x)), 3, 2, 1,
                               return_indices=True)
    assert torch.equal(ind, want_ind)
    offsets = ((ind // 11 - (2 * torch.arange(5).reshape(1, 1, 5, 1) - 1)) * 3
               + ind % 11 - (2 * torch.arange(6).reshape(1, 1, 1, 6) - 1)).to(torch.uint8)
    assert torch.equal(S.flat_indices(offsets | 0x80, 11), ind)
    gy = torch.randn(want.shape, generator=g)
    want.backward(gy)
    dx, dw, db = S.plain_backward(x, y, gy, stats, bn.weight, training)
    torch.testing.assert_close(dx, xb.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dw, bn_old.weight.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(db, bn_old.bias.grad, rtol=1e-5, atol=1e-5)


def test_stem_bytes_counts_each_pass():
    x = torch.empty(1024, 32, 32, 64, dtype=torch.bfloat16).permute(0, 3, 1, 2)
    xb, ob, ib = 134_217_728, 33_554_432, 16_777_216
    assert S.stem_bytes(x) == 5 * xb + 3 * ob + 3 * ib
    assert S.stem_bytes(x, training=False) == 4 * xb + 3 * ob + 3 * ib


@pytest.mark.parametrize("H,W,G,itemsize,want", [
    (32, 32, 8, 2, (4, 8, 9 * 32 * 64 * 2)),     # the CIFAR stem in bf16
    (112, 112, 8, 2, (1, 8, 3 * 112 * 64 * 2)),  # the ImageNet stem in bf16
    (32, 32, 8, 4, (2, 8, 5 * 32 * 64 * 4)),     # float32
    (7, 9, 8, 2, (4, 8, 7 * 9 * 64 * 2)),        # a band past the image's rows
    (16, 4096, 8, 2, (1, 1, 3 * 4096 * 8 * 2)),  # a wide row: one channel group
])
def test_band_geometry(H, W, G, itemsize, want):
    """The band a CTA of the normalise-pool pass takes, and the shared
    memory its min(H, 2R + 1) input rows need."""
    Ho = (H - 1) // 2 + 1
    R, gc = S._band(H, W, Ho, G, itemsize)
    smem = min(H, 2 * R + 1) * W * gc * 8 * itemsize
    assert (R, gc, smem) == want
    assert smem <= S.SMEM_MAX and 1 <= R <= Ho


def test_band_too_wide_raises():
    with pytest.raises(ValueError, match="does not fit"):
        S._band(8, 20000, 4, 8, 4)


@pytest.mark.parametrize("total,lanes,ctas", [(1024 * 32 * 32, 32, 660), (5, 32, 660),
                                              (8 * 56 * 56, 32, 396), (1000, 1, 7)])
def test_split_covers_every_item_once(total, lanes, ctas):
    blocks, per = S._split(total, lanes, ctas)
    assert blocks <= ctas and (blocks - 1) * per < total <= blocks * per


# --------------------------------------------------------------------------
# the card: the kernels against their plain versions
# --------------------------------------------------------------------------

def _run(x, bn, gy):
    """Forward and backward through `stem_tail`'s autograd Function: out,
    the offsets and statistics it saved for the backward, dx, dw, db."""
    xg = x.detach().clone().requires_grad_()
    out = S.stem_tail(xg, bn)
    _, idx, stats, _ = out.grad_fn.saved_tensors
    dx, dw, db = torch.autograd.grad(out, (xg, bn.weight, bn.bias), gy)
    return out.detach(), idx, stats, dx, dw, db


def _gy(N, C, H, W, dtype, card, seed=3):
    gen = torch.Generator(device=card).manual_seed(seed)
    return torch.randn(N, (H - 1) // 2 + 1, (W - 1) // 2 + 1, C, device=card,
                       generator=gen).to(dtype).permute(0, 3, 1, 2)


def _rel(got, want, floor):
    """The largest |got - want| over |want|, |want| taken as at least
    `floor`."""
    return ((got.float() - want.float()).abs() / want.float().abs().clamp(min=floor)).max().item()


def _rel_to_max(got, want):
    """The largest |got - want| over the largest |want|."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


# the main path's call first: one view of batch 512 (the views run one at a time)
CARD_SHAPES = [((512, 64, 32, 32), torch.bfloat16), ((1024, 64, 32, 32), torch.bfloat16),
               ((8, 64, 112, 112), torch.bfloat16), ((3, 64, 7, 9), torch.bfloat16),
               ((16, 64, 32, 32), torch.float32)]


@pytest.mark.card
@pytest.mark.parametrize("shape,dtype", CARD_SHAPES)
def test_card_kernels_hold_to_the_plain_versions(shape, dtype, card):
    """Training forward and backward: the statistics against torch's, the
    pooled output and the offsets bit for bit against aten's max-pool of the
    kernels' y, the gradients against aten's pool and ReLU backward and BN's
    backward formulas in float32, the running statistics against the old
    composition's. Each also within its bound relative to the plain
    version's values: the statistics and dweight, dbias 1e-4, dx a bf16
    rounding (1e-5 in float32) of its largest, the running statistics
    1e-5."""
    N, C, H, W = shape
    bn, bn_old = _bn(C, device=card), _bn(C, device=card)
    x = _x(*shape, dtype=dtype, device=card)
    gy = _gy(N, C, H, W, dtype, card)
    out, idx, stats, dx, dw, db = _run(x, bn, gy)
    torch.cuda.synchronize()

    want = S.plain_stats(x, bn)
    assert ((stats[0] - want[0]).abs() <= 1e-5 / want[1] + 1e-6).all()
    torch.testing.assert_close(stats[1:], want[1:], rtol=1e-5, atol=1e-6)
    assert _rel(stats, want, 1e-3) <= 1e-4

    y, out_ref, ind_ref = S.plain_tail(x, stats)
    assert out.is_contiguous(memory_format=torch.channels_last) and out.dtype == dtype
    assert torch.equal(out, out_ref)
    assert torch.equal(S.flat_indices(idx, W), ind_ref)
    assert torch.equal((idx & 0x80) != 0, out <= 0)

    dx_ref, dw_ref, db_ref = S.plain_backward(x, y, gy, stats, bn.weight)
    torch.testing.assert_close(dw, dw_ref, rtol=1e-4, atol=1e-4 * dw_ref.abs().max().item())
    torch.testing.assert_close(db, db_ref, rtol=1e-4, atol=1e-4 * db_ref.abs().max().item())
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(dx.float(), dx_ref.float(), rtol=ulp,
                               atol=ulp * dx_ref.float().abs().max().item() / 64)
    assert max(_rel_to_max(dw, dw_ref), _rel_to_max(db, db_ref)) <= 1e-4
    assert _rel_to_max(dx, dx_ref) <= ulp

    _old(x.clone(), bn_old)
    for k in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(bn, k), getattr(bn_old, k), rtol=1e-5, atol=1e-6)
        assert _rel(getattr(bn, k), getattr(bn_old, k), 1e-3) <= 1e-5, k
    assert int(bn.num_batches_tracked) == int(bn_old.num_batches_tracked) == 1


@pytest.mark.card
@pytest.mark.parametrize("shape,dtype", CARD_SHAPES)
def test_card_training_forward_without_grad_is_the_recorded_one(shape, dtype, card):
    """A training forward that autograd does not record (BYOL's target
    tower, MoCo's key tower) launches three kernels, writes no offsets, and
    gives the recorded forward's output and running statistics bit for
    bit (that forward is held to the plain versions above)."""
    C = shape[1]
    bn, bn_ng = _bn(C, device=card), _bn(C, device=card)
    x = _x(*shape, dtype=dtype, device=card)
    before = trace.counters.get("stem.launches", 0)
    with torch.no_grad():
        got = S.stem_tail(x, bn_ng)
    assert trace.counters["stem.launches"] - before == 3 and got.grad_fn is None
    want = S.stem_tail(x.clone().requires_grad_(), bn)
    assert torch.equal(got, want.detach())
    for k in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.equal(getattr(bn_ng, k), getattr(bn, k)), k
    assert int(bn_ng.num_batches_tracked) == 1


@pytest.mark.card
@pytest.mark.parametrize("shape,dtype", CARD_SHAPES)
def test_card_eval_holds_to_the_plain_versions(shape, dtype, card):
    """Eval mode (KNN's and the probe's features) through `stem_tail`: the
    statistics from the running ones against `plain_stats` (within 1e-6 of
    each, relative); the output without a gradient and with one bit for bit
    `plain_tail`'s from them, the offsets aten's; the gradients those of
    BN's eval backward (the statistics constants); the running statistics
    untouched."""
    N, C, H, W = shape
    bn = _bn(C, device=card).eval()
    x = _x(*shape, dtype=dtype, device=card)
    gy = _gy(N, C, H, W, dtype, card, seed=6)
    with torch.no_grad():
        no_grad = S.stem_tail(x, bn)
    out, idx, stats, dx, dw, db = _run(x, bn, gy)
    want = S.plain_stats(x, bn)
    torch.testing.assert_close(stats, want, rtol=1e-6, atol=1e-7)
    assert _rel(stats, want, 1e-3) <= 1e-6
    y, out_ref, ind_ref = S.plain_tail(x, stats)
    assert torch.equal(no_grad, out_ref) and torch.equal(out, out_ref)
    assert torch.equal(S.flat_indices(idx, W), ind_ref)
    dx_ref, dw_ref, db_ref = S.plain_backward(x, y, gy, stats, bn.weight, training=False)
    torch.testing.assert_close(dw, dw_ref, rtol=1e-4, atol=1e-4 * dw_ref.abs().max().item())
    torch.testing.assert_close(db, db_ref, rtol=1e-4, atol=1e-4 * db_ref.abs().max().item())
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(dx.float(), dx_ref.float(), rtol=ulp,
                               atol=ulp * dx_ref.float().abs().max().item() / 64)
    fresh = _bn(C, device=card)
    for k in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.equal(getattr(bn, k), getattr(fresh, k)), k


@pytest.mark.card
def test_card_bf16_against_the_old_composition(card):
    """bf16 at the main path's call (512 x 64 x 32 x 32), through autograd,
    against aten's BN, ReLU and max-pool on the same input. Both round y to
    bf16 before the max, from statistics each computes in its own order and
    form (the kernels x * scale + shift, aten w * (x - mean) * rstd + b),
    so a y within a rounding of a bf16 boundary may round the other way on
    one side, and its window's max or argmax differ. Held: at most 1e-3 of
    the pooled values and of the argmaxes differ, a value by at most one
    bf16 step; dx within 5 % by norm (a moved argmax moves its window's
    gradient), the BN's gradients and running statistics close."""
    N, C, H, W = 512, 64, 32, 32
    bn, bn_old = _bn(C, device=card), _bn(C, device=card)
    x = _x(N, C, H, W, dtype=torch.bfloat16, device=card)
    gy = _gy(N, C, H, W, torch.bfloat16, card, seed=7)
    out, idx, stats, dx, dw, db = _run(x, bn, gy)
    xb = x.clone().requires_grad_()
    want, ind = F.max_pool2d(F.relu(bn_old(xb)), 3, 2, 1, return_indices=True)
    dx_old, dw_old, db_old = torch.autograd.grad(want, (xb, bn_old.weight, bn_old.bias), gy)
    values = (out != want).float().mean().item()
    argmax = (S.flat_indices(idx, W) != ind).float().mean().item()
    floor = 2.0 ** -20 * want.float().abs().max().item()
    steps = ((out.float() - want.float()).abs()
             / (want.float().abs() * 2.0 ** -7).clamp(min=floor)).max().item()
    dx_err = ((dx.float() - dx_old.float()).norm() / dx_old.float().norm()).item()
    print(f"stem 512x64x32x32 bf16 against aten's composition: {values:.3e} of the pooled "
          f"values differ (up to {steps:.3f} bf16 steps), {argmax:.3e} of the argmaxes; dx "
          f"{dx_err:.3e} by norm")
    assert values <= 1e-3 and argmax <= 1e-3 and steps <= 1.0
    assert dx_err <= 0.05
    torch.testing.assert_close(dw, dw_old, rtol=1e-2, atol=1e-2 * dw_old.abs().max().item())
    torch.testing.assert_close(db, db_old, rtol=1e-2, atol=1e-2 * db_old.abs().max().item())
    torch.testing.assert_close(bn.running_mean, bn_old.running_mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bn.running_var, bn_old.running_var, rtol=1e-5, atol=1e-6)


@pytest.mark.card
def test_card_float32_agrees_with_the_old_composition(card):
    """End to end in float32 through autograd: the wrapper against the old
    composition (aten's BN, ReLU and max-pool) on the same input, whose
    values lie on a grid of 1/8 so that each window's max is the same
    position on both sides (equal inputs tie on both)."""
    N, C, H, W = 32, 64, 32, 32
    bn, bn_old = _bn(C, device=card), _bn(C, device=card)
    g = torch.Generator(device=card).manual_seed(4)
    x = (torch.randint(-40, 40, (N, H, W, C), device=card, generator=g) / 8).permute(0, 3, 1, 2)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    got, want = S.stem_tail(xa, bn), _old(xb, bn_old)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    gy = torch.randn_like(want)
    got.backward(gy)
    want.backward(gy)
    err = (xa.grad - xb.grad).norm() / xb.grad.norm()
    assert err < 1e-5, err
    torch.testing.assert_close(bn.weight.grad, bn_old.weight.grad, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(bn.bias.grad, bn_old.bias.grad, rtol=1e-4, atol=1e-3)


@pytest.mark.card
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_card_ties_and_nan_pick_atens_argmax(mode, card):
    """Planted ties (a window of one value) pick the first position in
    row-major order; a NaN wins its windows (in training it makes its whole
    channel NaN, and the last position of each window wins), as aten's
    max-pool picks them from the same y."""
    N, C, H, W = 4, 64, 16, 16
    bn = _bn(C, device=card).train(mode == "train")
    x = _x(N, C, H, W, dtype=torch.bfloat16, device=card).contiguous(
        memory_format=torch.channels_last)
    x[:, :, 1:4, 1:4] = 2.5          # window (1, 1) all one value
    x[:, :, 8:10, 8:12] = -4.0       # ties at zero after the ReLU
    x[0, 5, 6, 7] = float("nan")
    with torch.no_grad():
        out, idx, stats = S._forward(x, bn, with_idx=True)
    y, out_ref, ind_ref = S.plain_tail(x, stats)
    flat = S.flat_indices(idx, W)
    assert torch.equal(out.isnan(), out_ref.isnan())
    assert torch.equal(out.nan_to_num(-1.0), out_ref.nan_to_num(-1.0))
    assert torch.equal(flat, ind_ref)
    others = torch.arange(C, device=card) != 5
    assert (flat[1:, others, 1, 1] == 1 * W + 1).all()   # the window's first position
    if mode == "eval":
        assert flat[0, 5, 3, 3] == 6 * W + 7 and out[0, 5, 3, 3].isnan()
    else:
        assert out[0, 5].isnan().all() and (flat[0, 5, 1:, 1:] % W % 2 == 1).all()


@pytest.mark.card
def test_card_eval_without_grad_launches_two_kernels(card):
    N, C, H, W = 8, 64, 32, 32
    bn = _bn(C, device=card).eval()
    x = _x(N, C, H, W, dtype=torch.bfloat16, device=card)
    before = trace.counters.get("stem.launches", 0)
    with torch.no_grad():
        out = S.stem_tail(x, bn)
    assert trace.counters["stem.launches"] - before == 2
    _, out_ref, _ = S.plain_tail(x, S.plain_stats(x, bn))
    assert (out.float() - out_ref.float()).abs().max() <= 2 ** -7 * out_ref.float().abs().max()
    assert int(bn.num_batches_tracked) == 0


@pytest.mark.card
def test_card_launch_counts_and_errors(card):
    C = 64
    bn = _bn(C, device=card)
    x = _x(4, C, 16, 16, dtype=torch.bfloat16, device=card).requires_grad_()
    before = trace.counters.get("stem.launches", 0)
    S.stem_tail(x, bn).float().sum().backward()
    assert trace.counters["stem.launches"] - before == 6
    with torch.no_grad():
        S.stem_tail(x, bn)
    assert trace.counters["stem.launches"] - before == 9
    for bad in (x.detach().contiguous(),                       # NCHW
                x.detach().half(),                             # float16
                _x(4, 12, 16, 16, device=card)):               # 12 channels
        with pytest.raises(ValueError):
            S.stem_tail(bad, bn if bad.shape[1] == C else _bn(12, device=card))


@pytest.mark.card
def test_card_calls_and_graph_replays_are_bit_equal(card):
    """Two eager calls, and a CUDA-graph replay of the same call, give the
    same outputs, gradients and running statistics bit for bit."""
    N, C, H, W = 256, 64, 32, 32
    # one side stream for every call, as the trainer warms up and captures
    # its step: autograd's nodes then run on the capture's stream
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bn = _bn(C, device=card)
        start = {k: v.clone() for k, v in bn.state_dict().items()}
        x = _x(N, C, H, W, dtype=torch.bfloat16, device=card).requires_grad_()
        gy = torch.randn(N, 16, 16, C, device=card).to(torch.bfloat16).permute(0, 3, 1, 2)

        def step():
            out = S.stem_tail(x, bn)
            return (out, *torch.autograd.grad(out, (x, bn.weight, bn.bias), gy))

        def fresh():
            with torch.no_grad():
                for k, v in bn.state_dict().items():
                    v.copy_(start[k])

        def kept(outs):
            return [t.clone() for t in outs] + [bn.running_mean.clone(), bn.running_var.clone()]

        runs = []
        for _ in range(2):
            fresh()
            runs.append(kept(step()))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            static = step()
        fresh()
        graph.replay()
        runs.append(kept(static))
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)
    for a, b in zip(runs[0], runs[2]):
        assert torch.equal(a, b)
