"""The frozen arithmetic: the photometric kernel's bytes and operations,
the analytic FLOPs of each configuration's step against
`torch.utils.flop_counter` over the reference's own model, and the device
timeline's busy time, kinds and gaps."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import devtrace, inputs, reference
from perfbench.counts import byol, photometric, resnet18, simclr
from perfbench.reference import resnet18 as ref_resnet18
from perfbench.reference.common import identity

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = {"simclr": "simclr_resnet18_cifar10", "byol": "byol_resnet18_cifar10"}
H100 = {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}


def _cfg(algo):
    return json.loads((ROOT / "perfbench" / "configs" / f"{CONFIGS[algo]}.json").read_text())


def test_photometric_count_at_the_main_path_batch():
    """B = 512 at 32x32: the inputs the kernel was timed on carry 362 rows
    with a hue shift and 150 with the gray gate."""
    assert photometric.nbytes(512, 32, 32) == 12_601_344
    assert photometric.float_ops(512, 32, 32, HUE_ROWS, GATE_ROWS) == 43_069_440
    least, by = photometric.least_seconds(12_601_344, 43_069_440, H100)
    assert by == "bytes" and least == pytest.approx(12_601_344 / 3.35e12)


def test_photometric_rows_in_expectation():
    cfg = _cfg("simclr")["data"]["transforms"]["train"]
    assert photometric.expected_rows(512, cfg) == (512 * 0.8, 512 * 0.2)


def test_resnet18_forward_flops_match_the_counter():
    cfg = _cfg("simclr")
    w = inputs.weights(ref_resnet18.specs("", cfg), 5, "cpu")
    x = torch.rand(2, 32, 32, 3)
    with FlopCounterMode(display=False) as counter:
        ref_resnet18.forward(w, "", x)
    assert counter.get_total_flops() == 2 * resnet18.forward_flops(cfg, (32, 32))
    assert resnet18.forward_flops(cfg, (32, 32)) == 280_363_008


@pytest.mark.parametrize("algo", ["simclr", "byol"])
def test_step_flops_match_the_counter(algo):
    """The counter over the reference's loss and gradients at batch 4: the
    analytic count less the first convolution's input gradient, which
    autograd does not compute (the images need none)."""
    cfg, batch = _cfg(algo), 4
    mod = reference.algorithm(algo)
    params = inputs.weights(mod.specs(cfg), 5, "cpu")
    v1, v2 = torch.rand(batch, 32, 32, 3), torch.rand(batch, 32, 32, 3)
    leaves = [params[n].requires_grad_(True) for n in mod.trainable(params)]
    with FlopCounterMode(display=False) as counter:
        torch.autograd.grad(mod.loss(params, [v1, v2], cfg, identity, {}), leaves)
    first_conv = 2 * 32 * 32 * 64 * 3 * 9
    count = {"simclr": simclr, "byol": byol}[algo].flops_per_image(cfg, (32, 32), batch)
    assert counter.get_total_flops() == count * batch - 2 * first_conv * batch


def test_per_image_flops_at_the_cells_batch():
    assert simclr.flops_per_image(_cfg("simclr"), (32, 32), 512) == 1_687_683_072
    assert byol.flops_per_image(_cfg("byol"), (32, 32), 512) == 2_248_540_160


def test_busy_time_is_the_union_of_device_spans():
    assert devtrace.busy_us([]) == 0.0
    assert devtrace.busy_us([(0, 10), (5, 12), (6, 7), (12, 14), (20, 21)]) == 15.0
    assert devtrace.gaps([(0, 10), (5, 12), (6, 7), (12, 14), (20, 21), (30, 31)]) == [
        (14, 20), (21, 30)]


def test_kinds_by_kernel_name():
    cases = {"void photometric_kernel<true>(...)": "photometric kernel",
             "sm90_xmma_gemm_bf16bf16_bf16f32": "matmul and conv",
             "cudnn::bn_fw_tr_1C11_kernel_NCHW": "normalisation",
             "void at::native::batch_norm_collect_statistics_kernel": "normalisation",
             "void at::native::(anonymous)::multi_tensor_apply_kernel<FusedSgdMathFunctor>":
                 "optimizer",
             "Memcpy DtoD (Device -> Device)": "copies and casts",
             "void at::native::max_pool_forward_nhwc": "pooling",
             "void at::native::vectorized_elementwise_kernel<4, relu>": "elementwise and other"}
    for name, kind in cases.items():
        assert devtrace.kind_of(name) == kind, name


def test_timeline_summaries():
    ops = [("gemm_a", 0.0, 4.0), ("relu", 4.0, 5.0), ("gemm_a", 9.0, 13.0), ("relu", 20.0, 21.0)]
    host = [("perfbench.step", 0.0, 30.0), ("cudaGraphLaunch", 14.0, 19.0)]
    assert devtrace.ms_by_kind(ops, 2) == {"matmul and conv": 0.004, "elementwise and other": 0.001}
    assert devtrace.top_ops(ops, 1) == [["gemm_a", 8e-6]]
    assert devtrace.longest_gaps(ops, host) == [["cudaGraphLaunch", 7e-6],
                                                ["perfbench.step", 4e-6]]
    assert devtrace.span_us(ops) == 21.0 and devtrace.span_us([]) == 0.0


HUE_ROWS, GATE_ROWS = 372, 148   # counted on the card from those inputs
