"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Each test makes its inputs with numpy from a seed, runs the JAX function and
the port's counterpart on them, and compares the results as numpy arrays.
Weights move from the JAX side to the port through ssv_tpu_torch/convert.py.
"""

import os
import pickle

import jax
import numpy as np
import torch


def to_numpy_tree(tree):
    """A flax variable tree (nested dicts of JAX arrays) as numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def stage_fake_cifar(root, n_train=128, n_test=256, seed=0):
    """Tiny CIFAR-10 pickle batches (data_batch_1..5, n_train images in all,
    + test_batch) under root/cifar-10-batches-py, so a loader takes the real
    reader path."""
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i, n in enumerate(np.array_split(np.arange(n_train), 5), start=1):
        with open(os.path.join(d, f"data_batch_{i}"), "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (len(n), 3072), dtype=np.uint8),
                         "labels": rng.randint(0, 10, len(n)).tolist()}, f)
    with open(os.path.join(d, "test_batch"), "wb") as f:
        pickle.dump({"data": rng.randint(0, 256, (n_test, 3072), dtype=np.uint8),
                     "labels": rng.randint(0, 10, n_test).tolist()}, f)
    return d


def t(a, dtype=None):
    """numpy -> CPU torch tensor (a copy, so the numpy input stays intact)."""
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


SMALL_STAGES = (1, 1)   # a two-stage ResNet: 128 features


def small_resnet18(monkeypatch, arch="resnet18"):
    """Makes `arch` (`resnet18`, or `resnet50`) a two-stage ResNet of its
    block (BasicBlock: 128 features; Bottleneck: 512) in both packages'
    registries, so an algorithm builds at test size through its usual
    constructor."""
    from ssv_tpu.models import registry as jax_registry
    from ssv_tpu.models import resnet as JR
    from ssv_tpu_torch.models import registry as torch_registry
    from ssv_tpu_torch.models import resnet as TR

    block = {"resnet18": "BasicBlock", "resnet50": "Bottleneck"}[arch]
    jblock, tblock = getattr(JR, block), getattr(TR, block)
    dim = 128 * tblock.expansion
    monkeypatch.setitem(jax_registry.NETWORKS, arch, {
        "net": lambda **kw: JR.ResNet(block=jblock, stage_sizes=SMALL_STAGES, **kw),
        "dim": dim})
    monkeypatch.setitem(torch_registry.NETWORKS, arch, {
        "net": lambda **kw: TR.ResNet(tblock, SMALL_STAGES, **kw), "dim": dim})


def strict_jit(fn, *args):
    """`fn(*args)` compiled with XLA's excess precision off, so each bf16 op
    of a flax module rounds where its dtype says (XLA on the CPU otherwise
    keeps float32 between the ops it fuses, which no port can follow)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


# each algorithm's towers: head -> layers followed by BatchNorm (SeLA's
# model has cluster heads, PIRL's and DeepCluster's plain Dense layers, and
# no tower head)
TOWER_BN = {
    "simclr": ({"proj": (0, 1)}, None),
    "moco": ({"proj": ()}, {"proj": ()}),
    "byol": ({"proj": (0,), "pred": (0,)}, {"proj": (0,)}),
    "relic": ({"proj": (0,), "pred": (0,)}, {"proj": (0,)}),
    "simsiam": ({"proj": (0, 1, 2), "pred": (0,)}, {"proj": (0, 1, 2)}),
    "barlow": ({"proj": (0, 1)}, None),
    "swav": ({"proj": (0, 1)}, None),
    "sela": ({}, None),
    "dino": ({"proj": ()}, {"proj": ()}),
    "pirl": ({}, None),
    "deep_cluster": ({}, None),
}


def _jax_state_dicts(jstate, algo):
    """{module name: state_dict} of a JAX TrainState, through convert.py."""
    from ssv_tpu_torch.convert import extra_state_dicts, model_state_dict

    online, target = TOWER_BN[algo]
    out = {"model": model_state_dict(to_numpy_tree(jstate.params),
                                     to_numpy_tree(jstate.batch_stats), SMALL_STAGES,
                                     online)}
    out.update(extra_state_dicts(to_numpy_tree(jstate.extra), SMALL_STAGES, target or {}))
    return out


def load_jax_state(tstate, jstate, algo):
    """Loads a JAX TrainState's params, BN statistics and extra state (an EMA
    target or key tower, a queue or bank, SeLA's self-labelling state, DINO's
    teacher and center) into the port's TrainState."""
    for name, sd in _jax_state_dicts(jstate, algo).items():
        (tstate.model if name == "model" else tstate.extra[name]).load_state_dict(sd)


def assert_state_matches(tstate, jstate, algo, param_tol=1e-4, stat_tol=1e-5):
    """The port's model and extra modules against the JAX state: params
    within `param_tol`, BN running statistics and the float buffers of a
    queue, bank, SeLA's state or DINO's center within `stat_tol` (abs); integer buffers
    (a pointer, pseudo-labels, the best head) exactly."""
    pairs = [(name, tstate.model if name == "model" else tstate.extra[name], sd)
             for name, sd in _jax_state_dicts(jstate, algo).items()]
    assert {name for name, _, _ in pairs} == {"model", *tstate.extra}
    for name, module, want in pairs:
        got = module.state_dict()
        for k, w in want.items():
            g = got[k].detach().cpu()
            if not w.is_floating_point():
                np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=f"{name}.{k}")
                continue
            buffer = name in ("queue", "bank", "self_label", "center")
            tol = (stat_tol if buffer or k.endswith(("running_mean", "running_var"))
                   else param_tol)
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=tol,
                                       err_msg=f"{name}.{k}")
