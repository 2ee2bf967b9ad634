"""The port's build and measurement helpers that run without a card: the
build's library naming, the photometric kernel's least time from its
shapes, and how `tools/profile_report.py` reads a trace's device ops."""

import pytest
import torch

from ssv_tpu_torch.ops import build
from ssv_tpu_torch.tools.measure import photometric_bound


def test_library_name_follows_source_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("int f() { return 0; }")
    first = build.library_path("k")
    assert first == build.library_path("k")
    assert first.parent == build.BUILD_DIR
    assert first.name.startswith("libk_") and first.suffix == ".so"
    src.write_text("int f() { return 1; }")
    edited = build.library_path("k")
    assert edited != first
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-DX=1",))
    assert build.library_path("k") not in (first, edited)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_photometric_bound_at_the_main_path_shape():
    """Batch 512, 32x32: 6,291,456 bytes read and as many written, plus
    order and params, over 3.35 TB/s; the float operations are far below."""
    images = torch.zeros(512, 32, 32, 3)
    params = torch.zeros(512, 5)
    params[:, 3] = 0.1    # every image runs the hue round trip
    params[:256, 4] = 1.0  # half take the gray gate
    ms, by, nbytes, ops = photometric_bound(images, params)
    assert nbytes == 12_601_344 and by == "bytes"
    assert ms == pytest.approx(12_601_344 / 3.35e12 * 1e3)
    assert ops == 1024 * (512 * (9 + 24 + 23 + 34) + 256 * 5)


def test_photometric_bound_counts_the_ops_the_input_needs():
    images = torch.zeros(4, 8, 8, 3)
    params = torch.tensor([[1.0, 1.0, 1.0, 0.0, 0.0]] * 4)  # identity: no hue, no gate
    _, _, _, ops = photometric_bound(images, params)
    assert ops == 4 * 64 * (9 + 24 + 23)


def test_profile_report_busy_time_is_the_union_of_device_spans():
    from ssv_tpu_torch.tools.profile_report import busy_us

    assert busy_us([]) == 0.0
    # overlapping, nested, touching and apart
    assert busy_us([(0, 10), (5, 12), (6, 7), (12, 14), (20, 21)]) == 15.0


def test_profile_report_counts_device_ops_not_annotations():
    import types

    from ssv_tpu_torch.tools.profile_report import device_ops

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [types.SimpleNamespace(name=n, device_type=d, is_user_annotation=u)
              for n, d, u in (("gemm", cuda, False), ("Optimizer.step#X.step", cuda, False),
                              ("my_range", cuda, True), ("aten::mm", cpu, False),
                              ("Memcpy HtoD", cuda, False),
                              ("copy_kernel<{lambda()#3}>", cuda, False))]
    assert [e.name for e in device_ops(events)] == [
        "gemm", "Memcpy HtoD", "copy_kernel<{lambda()#3}>"]


def test_profile_report_kinds():
    from ssv_tpu_torch.tools.profile_report import kind_of

    assert kind_of("void photometric_kernel<16>(...)") == "photometric kernel"
    assert kind_of("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n") == "matmul and conv"
    assert kind_of("vectorized_layer_norm_kernel<float>") == "normalisation"
    assert kind_of("direct_copy_kernel_cuda") == "copies and casts"
    assert kind_of("GeluCUDAKernelImpl") == "elementwise and other"
