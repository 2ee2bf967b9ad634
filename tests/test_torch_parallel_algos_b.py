"""SwAV, SeLA, DINO (the 2-layer ViT), PIRL and DeepCluster: their
data-parallel steps in the port against the JAX steps at 2 ranks, as
tests/test_torch_parallel_algos.py sets out.

DINO's per-device step runs on the ViT, not on the small ResNet: there,
with 2 images a rank, JAX's own two adamw steps move the params by 7.5e-4
(1.5e-4 on the sync path) when the initial params are perturbed by 1e-6
relative, so no port can be held to 1e-4 on that case."""

import pytest
import torch

from test_torch_parallel_algos import check, check_per_device, run_group

torch.set_num_threads(2)

GROUP = ["swav", "sela", "dino", "pirl", "deep_cluster",
         "pdbn-swav", "pdbn-sela", "pdbn-dino", "pdbn-pirl", "pdbn-deep_cluster"]


@pytest.fixture(scope="module")
def results():
    return run_group(GROUP)


@pytest.mark.parametrize("name", [n for n in GROUP if not n.startswith("pdbn-")])
def test_sync_steps_match_jax(results, name):
    check(results, name)


@pytest.mark.parametrize("name", [n for n in GROUP if n.startswith("pdbn-")])
def test_per_device_steps_match_shard_map(results, name):
    check_per_device(results, name)
