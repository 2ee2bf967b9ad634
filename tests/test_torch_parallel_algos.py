"""Each algorithm's data-parallel steps in the port against the JAX steps:
two float32 steps at 2 ranks (spawned CPU processes on gloo, one thread
each) from the JAX weights and extra state (moved across by
ssv_tpu_torch/convert.py), on the same views, at the step tests' small size
(the two-stage ResNet; DINO's 2-layer ViT; batch 8, DINO 4).

  * sync: the JAX step jitted on the global batch (its single-device step,
    so the port's one-process step too);
  * `per_device_bn: true`: the JAX step under `shard_map` over
    `get_mesh(2)`, the batch sharded on `data`, with the same key on both
    replicas (the JAX trainer's per-replica key fold left out, so the
    draws are given); PIRL's permutation and negatives are JAX's, injected
    into `PIRL.draw`, each rank's its replica's. The JAX step reduces the
    gradients of every loss with `pmean` here: its `psum` for a loss of
    gathered rows (SimCLR, SwAV) is the gradient times the replica count,
    since the transpose of its all_gather already sums the replicas'
    cotangents (`test_jax_global_psum_is_the_gradient_times_the_world`
    pins it); the port's step is the single-process one.

The loss within 1e-5 relative, params 1e-4, BN statistics and buffers
1e-5, integer buffers exactly (`torch_helpers.assert_state_matches`), and
every rank's state bit for bit rank 0's. Under `per_device_bn` the BN
statistics differ from the sync step's. The cases are split between this
file and tests/test_torch_parallel_algos_b.py; each file spawns its ranks
once for all its cases.
"""

import copy
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import test_torch_algorithms as TA
import test_torch_algorithms_c as TC
import test_torch_deep_cluster as TDC
import test_torch_dino as TD
import test_torch_pirl as TP
import torch_helpers as th
from ssv_tpu.parallel.mesh import get_mesh
from ssv_tpu_torch.train.base import DataInfo as TDataInfo
from ssv_tpu_torch.train.registry import build_algorithm

torch.set_num_threads(2)
WORLD = 2


@functools.cache
def _ta_views(transforms, step):
    return TA._views({"data": {"transforms": json.loads(transforms)}}, step)


def _setup(algo):
    """(JAX algorithm, its initial state, the port case without `init`):
    the config, weights, extra state and two steps' views of the single-rank
    step test of the algorithm."""
    arch = "vit" if algo == "dino" else "resnet18"
    if algo in ("simclr", "byol", "simsiam", "relic", "barlow"):
        cfg = TA._config(algo, False)
        jalgo, jstate, _, _ = TA._pair(algo, cfg)
        info = (10, 64, TA.BATCH, 8)
        # the five configs share their transforms, and so their views
        batches = [_ta_views(json.dumps(cfg["data"]["transforms"]), s) for s in range(2)]
    elif algo in ("moco", "swav", "sela"):
        cfg = TC._config(algo)
        jalgo, jstate, _, _ = TC._pair(algo, cfg)
        info = (10, TC.N_TRAIN, TC.BATCH, TC.N_TRAIN // TC.BATCH)
        batches = [TC._batch(cfg, s) for s in range(2)]
    elif algo == "dino":
        cfg = TD._config(arch)
        jalgo, jstate, _, _ = TD._pair(arch, cfg)
        info = (10, TD.B, TD.B, 1)
        batches = [TD._batch(s) for s in range(2)]
    elif algo == "pirl":
        cfg = TP._config()
        jalgo, jstate, _, _ = TP._pair(cfg)
        info = (10, TP.N_TRAIN, TP.BATCH, TP.N_TRAIN // TP.BATCH)
        batches = []
        for s in range(2):
            aug_1, aug_2 = TP._views(cfg, s)
            batches.append({"aug_1": aug_1, "aug_2": aug_2,
                            "index": np.random.RandomState(100 + s).permutation(
                                TP.N_TRAIN)[:TP.BATCH]})
    else:
        cfg = TDC._config()
        labels = np.random.RandomState(3).randint(0, cfg["num_classes"], TDC.N_TRAIN)
        jalgo, jstate, _, _ = TDC._pair(cfg, labels)
        info = (10, TDC.N_TRAIN, TDC.BATCH, TDC.N_TRAIN // TDC.BATCH)
        fn = TDC.build_batch_transform(cfg["data"]["transforms"]["train"])
        batches = []
        for s in range(2):
            u8 = np.random.RandomState(s).randint(0, 256, (TDC.BATCH, TDC.SIZE, TDC.SIZE, 3),
                                                  dtype=np.uint8)
            ks = jax.random.split(jax.random.PRNGKey(10 + s), 2 * TDC.BATCH)
            batches.append({"aug_1": np.asarray(fn(ks[:TDC.BATCH], u8)),
                            "aug_2": np.asarray(fn(ks[TDC.BATCH:], u8)),
                            "index": np.random.RandomState(100 + s).permutation(
                                TDC.N_TRAIN)[:TDC.BATCH]})
    case = {"algo": algo, "cfg": cfg, "arch": arch, "info": info, "batches": batches}
    return jalgo, jstate, case


def _key(algo, s):
    # PIRL's step draws from its key (its test's keys); the others ignore it
    return jax.random.PRNGKey(s + 1 if algo == "pirl" else 0)


def _pirl_draws(case, per_device):
    """JAX's draws for each step: one for the global batch, or one for each
    replica's slice (the same key on both)."""
    cfg, draws = case["cfg"], []
    for s, batch in enumerate(case["batches"]):
        idx, n = batch["index"], len(batch["index"]) // WORLD

        def draw(i):
            return TP._jax_draws(_key("pirl", s), i, cfg["num_patches"], cfg["num_negatives"])
        draws.append([draw(idx[r * n:(r + 1) * n]) for r in range(WORLD)] if per_device
                     else draw(idx))
    return draws


def _jax_steps(jalgo, jstate, case, per_device):
    """The JAX side: two steps (and DINO's epoch EMA); returns the final
    state and the losses."""
    if per_device:
        grad_step, jalgo = jalgo.grad_step, copy.copy(jalgo)

        def pmean_grad_step(state, loss_fn, axis=None, loss_scope="local", **kw):
            return grad_step(state, loss_fn, axis=axis, loss_scope="local", **kw)
        jalgo.grad_step = pmean_grad_step

        def local(state, batch, key):
            return jalgo.train_step(state, batch, key, axis="data")
        step = jax.jit(shard_map(local, mesh=get_mesh(WORLD), in_specs=(P(), P("data"), P()),
                                 out_specs=(P(), P()), check_vma=False))
    else:
        step = jax.jit(jalgo.train_step)
    losses = []
    for s, batch in enumerate(case["batches"]):
        jstate, m = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                         _key(case["algo"], s))
        losses.append(float(m["loss"]))
    if case["algo"] == "dino":
        jstate = jalgo.post_epoch(jstate, 1)
    return jstate, losses


def run_group(names):
    """{name: (JAX final state, JAX losses, each rank's port result, the
    case)} for the cases `names` ("<algo>" or "pdbn-<algo>"), the port's
    side in one spawn of WORLD ranks."""
    refs, cases, setups = {}, {}, {}
    with pytest.MonkeyPatch.context() as mp:
        th.small_resnet18(mp)
        for name in names:
            per_device = name.startswith("pdbn-")
            algo = name.removeprefix("pdbn-")
            if algo not in setups:   # the sync and per-device cases share it
                setups[algo] = _setup(algo)
            jalgo, jstate, case = setups[algo]
            case = dict(case, cfg=dict(case["cfg"], per_device_bn=per_device),
                        init=th._jax_state_dicts(jstate, algo))
            if case["algo"] == "pirl":
                case["draws"] = _pirl_draws(case, per_device)
            refs[name] = _jax_steps(jalgo, jstate, case, per_device)
            cases[name] = case
    ranks = th.run_ranks(th.rank_algorithm_steps, WORLD, cases)
    return {name: (*refs[name], [r[name] for r in ranks], cases[name]) for name in names}


def check(results, name):
    """The assertions of the module docstring for one case."""
    jstate, jlosses, ranks, case = results[name]
    for r in ranks:
        for got, want in zip(r["losses"], jlosses):
            assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (name, got, want)
    th.assert_ranks_identical(ranks)
    with pytest.MonkeyPatch.context() as mp:
        th.small_resnet18(mp)
        talgo = build_algorithm(case["algo"], case["cfg"], case["arch"],
                                TDataInfo(*case["info"]), "cpu")
        tstate = th.load_state_dicts(talgo.init_state(torch.Generator().manual_seed(0)),
                                     ranks[0])
    assert tstate.step == int(jstate.step) == 2
    th.assert_state_matches(tstate, jstate, case["algo"])
    return tstate


def check_per_device(results, name):
    """`check`, and the per-device BN statistics differ from those of
    JAX's sync step on the same views (DINO's ViT has none)."""
    tstate = check(results, name)
    if results[name][3]["arch"] == "vit":
        return
    jsync = results[name.removeprefix("pdbn-")][0]
    pd = torch.cat([v.reshape(-1) for k, v in tstate.model.state_dict().items()
                    if k.endswith(("running_mean", "running_var"))])
    sync = torch.cat([torch.from_numpy(np.array(v)).reshape(-1) for v in
                      jax.tree_util.tree_leaves(jsync.batch_stats)])
    assert pd.shape == sync.shape and (pd.sort().values - sync.sort().values).abs().max() > 1e-6


GROUP = ["simclr", "byol", "simsiam", "relic", "barlow", "moco",
         "pdbn-simclr", "pdbn-byol", "pdbn-moco"]


@pytest.fixture(scope="module")
def results():
    return run_group(GROUP)


@pytest.mark.parametrize("name", [n for n in GROUP if not n.startswith("pdbn-")])
def test_sync_steps_match_jax(results, name):
    check(results, name)


@pytest.mark.parametrize("name", [n for n in GROUP if n.startswith("pdbn-")])
def test_per_device_steps_match_shard_map(results, name):
    check_per_device(results, name)
