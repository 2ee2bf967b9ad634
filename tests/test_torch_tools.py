"""The port's build and measurement helpers that run without a card: the
build's library naming and the photometric kernel's least time from its
shapes."""

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
