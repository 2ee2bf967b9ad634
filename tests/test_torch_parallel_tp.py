"""The port's model axis (ssv_tpu_torch/parallel/mesh.py's (data, model)
layout; SwAV's prototype table sharded over the model group) across spawned
CPU ranks on gloo, one thread each, against the port's one-process functions
and the JAX package's, on inputs made from a numpy seed, float32:

  * the rank -> (data, model) layout against `np.arange(n).reshape(n // M, M)`,
    and the groups carry collectives;
  * `Prototypes`' shards, stacked, are the one-process table bit for bit;
  * `sinkhorn_codes` and `swav_loss` at M = 2 and 4 (one data rank) against
    the port's one-process functions and JAX's: the loss, the gathered codes,
    dz1, dz2 and each prototype row's gradient within rtol 1e-5, atol 1e-6
    (no factor of M on any of them);
  * one and two SwAV steps on `tiny` (the JAX dry run's phase-2 shapes,
    `__graft_entry__.py:172-219`, at a global batch of 8) at (data x model)
    = (1 x 2), (2 x 2) and (2 x 1) against the JAX step on a (2, 2) mesh of
    the conftest's virtual CPU devices, the table sharded `P("model",
    None)`, and against the unsharded JAX step: the loss within 1e-5
    relative, every parameter (each table row included) within 1e-4, the
    bank within 1e-5 and its pointer exactly; the tower the same on every
    rank and each shard the same across its data group, bit for bit, also
    when one model rank's tower gradients differ in their last bits;
  * the sync BatchNorm at (2 x 2) takes its statistics over the data group:
    against the whole batch (the port's and flax's) within 1e-5;
  * a model axis that does not divide K or the world raises, and so does a
    checkpoint under a model axis.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_helpers as th
from ssv_tpu.objectives import sinkhorn_codes as jax_sinkhorn_codes
from ssv_tpu.objectives import swav_loss as jax_swav_loss
from ssv_tpu.state.banks import RingBuffer as JRing
from ssv_tpu.train.algorithms.swav import SwAV as JSwAV
from ssv_tpu.train.base import DataInfo as JDataInfo
from ssv_tpu_torch.convert import gather_prototypes, prototype_shard
from ssv_tpu_torch.models.heads import Prototypes
from ssv_tpu_torch.objectives.losses import sinkhorn_codes, swav_loss
from ssv_tpu_torch.parallel import mesh
from test_torch_parallel import BN_CASES, _flax_bn

torch.set_num_threads(2)

BATCH, SIZE, STEPS = 8, 16, 2
INFO = (10, 64, BATCH, 8)
# the JAX dry run's phase-2 config, float32
CFG = {"epochs": 1, "hidden_dim": 32, "proj_dim": 16, "prototype_size": 128,
       "feature_bank_size": 32, "encoder": {"features": 32}, "compute_dtype": "float32",
       "optimizer": {"name": "sgd", "lr": 0.1, "weight_decay": 1e-6},
       "scheduler": {"name": "cosine", "warmup_epochs": 0},
       "loss_fn": {"temperature": 0.1, "sinkhorn_eps": 0.05, "sinkhorn_iters": 3}}
LAYOUTS = [(1, 2), (2, 2), (2, 1)]      # (data, model)


def _unit(rs, n, d):
    z = rs.randn(n, d).astype(np.float32)
    return z / np.linalg.norm(z, axis=1, keepdims=True)


def _loss_case():
    """Global rows of both views, a bank and a 128 x 16 table (normalized),
    as SwAV's loss sees them."""
    rs = np.random.RandomState(0)
    return {"z1": _unit(rs, BATCH, 16), "z2": _unit(rs, BATCH, 16), "bank": _unit(rs, 32, 16),
            "protos": _unit(rs, 128, 16), "cfg": dict(CFG["loss_fn"])}


LOSS_CASE = _loss_case()


def _batches():
    rs = np.random.RandomState(1)
    return [{k: rs.randn(BATCH, SIZE, SIZE, 3).astype(np.float32) for k in ("aug_1", "aug_2")}
            for _ in range(STEPS)]


@functools.cache
def _jax_swav():
    """The JAX SwAV's initial state (as port state dicts) and, after each of
    the steps, its loss and state: unsharded (jit) and on the dry run's
    (2, 2) mesh with the table sharded over `model`."""
    jalgo = JSwAV(CFG, "tiny", JDataInfo(*INFO))
    s0 = jalgo.init_state(jax.random.PRNGKey(0))
    rs = np.random.RandomState(2)
    s0 = s0.replace(extra={"bank": JRing(jnp.asarray(_unit(rs, 32, 16)),
                                         jnp.asarray(0, jnp.int32))})
    batches = _batches()
    key = jax.random.PRNGKey(2)
    step = jax.jit(jalgo.train_step)
    state, plain = s0, []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, key)
        plain.append((float(m["loss"]), th._jax_state_dicts(state, "swav")))

    mesh2 = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    rep2 = NamedSharding(mesh2, P())
    batch_sh = NamedSharding(mesh2, P("data"))
    proto_sh = NamedSharding(mesh2, P("model", None))
    state = jax.device_put(s0, rep2)
    state = state.replace(params={
        "model": state.params["model"],
        "prototypes": {"table": jax.device_put(state.params["prototypes"]["table"], proto_sh)}})
    sharded = []
    with mesh2:
        for b in batches:
            state, m = step(state, {k: jax.device_put(jnp.asarray(v), batch_sh)
                                    for k, v in b.items()}, key)
            sharded.append((float(m["loss"]), th._jax_state_dicts(state, "swav")))
    spec = state.params["prototypes"]["table"].sharding.spec
    return th._jax_state_dicts(s0, "swav"), plain, sharded, spec


@functools.cache
def _ranks(data, model):
    """Every case that runs at this layout, in one spawn."""
    cases = {"layout": None}
    if data == 1:
        cases.update(loss=LOSS_CASE, checkpoint=None)
    if (data, model) in LAYOUTS:
        init = _jax_swav()[0]
        cases["steps"] = {"cfg": CFG, "info": INFO, "init": init, "batches": _batches()}
    if (data, model) == (2, 2):
        cases["bn"] = BN_CASES
        cases["jittered"] = dict(cases["steps"], jitter=True)
    return th.run_ranks(th.rank_tp, data * model, model, cases)


@pytest.mark.parametrize("data,model", [(2, 2), (1, 4), (1, 2), (2, 1)],
                         ids=["2x2", "1x4", "1x2", "2x1"])
def test_layout_matches_the_jax_mesh(data, model):
    """World rank r at (grid row, grid column) of
    np.arange(n).reshape(n // M, M): data rank r // M, model rank r % M; its
    data group is its column, its model group its row, and a sum over each
    group adds the world ranks there."""
    grid = np.arange(data * model).reshape(data, model)
    for out in _ranks(data, model):
        r = out["layout"]["rank"]
        d, m = map(int, np.argwhere(grid == r)[0])
        lay = out["layout"]
        assert lay["data"] == (d, data) and lay["model"] == (m, model)
        assert lay["data_group"] == grid[:, m].tolist()
        assert lay["model_group"] == grid[d].tolist()
        assert lay["data_sum"] == grid[:, m].sum() and lay["model_sum"] == grid[d].sum()


@pytest.mark.parametrize("shards", [2, 4])
def test_prototype_shards_stack_to_the_table(shards):
    """Each shard draws the whole table from the generator and keeps its
    rows: stacked, the one-process table bit for bit, and the generator
    left where one process leaves it."""
    one = Prototypes(128, 16)
    g = torch.Generator().manual_seed(5)
    one.init_weights(g)
    after = torch.randn(3, generator=g)
    parts = []
    for m in range(shards):
        p = Prototypes(128, 16, shards, m)
        gm = torch.Generator().manual_seed(5)
        p.init_weights(gm)
        assert p.table.shape == (128 // shards, 16)
        assert torch.equal(torch.randn(3, generator=gm), after)
        parts.append(p.table.detach().numpy())
    assert np.array_equal(gather_prototypes(parts), one.table.detach().numpy())
    for m in range(shards):
        assert np.array_equal(prototype_shard(one.table.detach().numpy(), m, shards), parts[m])


def _one_process_loss():
    """The port's one-process loss, codes and gradients, and JAX's."""
    c = LOSS_CASE
    z1, z2, protos = (torch.from_numpy(c[k]).requires_grad_(True) for k in ("z1", "z2", "protos"))
    bank = torch.from_numpy(c["bank"])
    loss = swav_loss(z1, z2, protos, bank_features=bank, **c["cfg"])
    loss.backward()
    codes = sinkhorn_codes(torch.cat([z1, bank]).detach() @ protos.detach().T,
                           c["cfg"]["sinkhorn_eps"], c["cfg"]["sinkhorn_iters"])
    port = {"loss": loss.item(), "codes": codes.numpy(), "dz1": z1.grad.numpy(),
            "dz2": z2.grad.numpy(), "dprotos": protos.grad.numpy()}

    def f(a, b, p):
        return jax_swav_loss(a, b, p, bank_features=jnp.asarray(c["bank"]), **c["cfg"])

    args = tuple(jnp.asarray(c[k]) for k in ("z1", "z2", "protos"))
    jloss, grads = jax.value_and_grad(f, argnums=(0, 1, 2))(*args)
    jcodes = jax_sinkhorn_codes(jnp.concatenate([args[0], jnp.asarray(c["bank"])]) @ args[2].T,
                                c["cfg"]["sinkhorn_eps"], c["cfg"]["sinkhorn_iters"])
    jax_out = {"loss": float(jloss), "codes": np.asarray(jcodes), "dz1": np.asarray(grads[0]),
               "dz2": np.asarray(grads[1]), "dprotos": np.asarray(grads[2])}
    return port, jax_out


def _gathered_loss(model):
    """The ranks' results joined: codes and prototype gradients stacked over
    the model ranks (columns and rows); the loss and dz of each rank."""
    ranks = [out["loss"] for out in _ranks(1, model)]
    return ranks, {"codes": np.concatenate([r["codes"].numpy() for r in ranks], axis=1),
                   "dprotos": gather_prototypes([r["dprotos"].numpy() for r in ranks])}


@pytest.mark.parametrize("model", [2, 4])
def test_sharded_sinkhorn_codes_match(model):
    """The codes of view 1's scores, each rank's K/M columns gathered,
    against the one-process codes (the port's and JAX's)."""
    _, joined = _gathered_loss(model)
    for want in _one_process_loss():
        np.testing.assert_allclose(joined["codes"], want["codes"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(joined["codes"].sum(axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("model", [2, 4])
def test_sharded_swav_loss_and_gradients_match(model):
    """Every rank's loss, dz1 and dz2 (the copy into the model group sums the
    shards' shares once), and each table row's gradient (the partial sums'
    backward hands each shard its gradient once), against one process's:
    the port's and JAX's."""
    ranks, joined = _gathered_loss(model)
    for want in _one_process_loss():
        for r in ranks:
            assert abs(r["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
            for k in ("dz1", "dz2"):
                np.testing.assert_allclose(r[k].numpy(), want[k], rtol=1e-5, atol=1e-6,
                                           err_msg=k)
        np.testing.assert_allclose(joined["dprotos"], want["dprotos"], rtol=1e-5, atol=1e-6)
    assert np.abs(joined["dprotos"]).max() > 1e-3   # the table's gradient is not ~0


def _joined_state(ranks, model, step):
    """Rank 0's tower and bank, the table gathered from data row 0's model
    ranks."""
    first = ranks[0]["steps"][step]
    state = dict(first["model"])
    state["prototypes.table"] = torch.cat(
        [ranks[m]["steps"][step]["model"]["prototypes.table"] for m in range(model)])
    return {"model": state, "bank": first["bank"]}


def _assert_state(got, want, param_tol=1e-4, stat_tol=1e-5):
    assert got.keys() == want.keys()
    for name in want:
        extra = set(got[name]) - set(want[name])
        assert set(want[name]) <= set(got[name]), name
        assert all(k.endswith("num_batches_tracked") for k in extra), extra
        for k, w in want[name].items():
            g = got[name][k]
            if not w.is_floating_point():
                assert torch.equal(g, w), f"{name}.{k}"
                continue
            tol = stat_tol if name == "bank" or k.endswith(("running_mean", "running_var")) \
                else param_tol
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=tol,
                                       err_msg=f"{name}.{k}")


@pytest.mark.parametrize("step", [0, 1], ids=["one-step", "two-steps"])
@pytest.mark.parametrize("data,model", LAYOUTS, ids=["1x2", "2x2", "2x1"])
def test_swav_steps_match_jax(data, model, step):
    """After one and after two steps: every rank's loss metric, and the
    gathered state (tower, every table row, BN statistics, bank), against
    the JAX step on the (2, 2) mesh with the table sharded over `model` and
    against the unsharded JAX step."""
    _, plain, sharded, spec = _jax_swav()
    assert tuple(spec)[0] == "model"    # the JAX table stayed sharded
    ranks = _ranks(data, model)
    got = _joined_state(ranks, model, step)
    assert got["model"]["prototypes.table"].shape == (128, 16)
    for want_loss, want in (plain[step], sharded[step]):
        for r in ranks:
            loss = r["steps"][step]["loss"]
            assert abs(loss - want_loss) <= 1e-5 * max(1.0, abs(want_loss)), (loss, want_loss)
        _assert_state(got, want)


@pytest.mark.parametrize("data,model", LAYOUTS, ids=["1x2", "2x2", "2x1"])
def test_swav_steps_replicated_as_the_mesh_says(data, model):
    """Bit for bit, after each step: the tower and the bank the same on
    every rank; each shard the same across its data group (ranks m, M + m,
    ...); the shards of one data row distinct."""
    ranks = _ranks(data, model)
    for step in range(STEPS):
        outs = [r["steps"][step] for r in ranks]
        for r, out in enumerate(outs):
            for k, v in out["model"].items():
                ref = outs[r % model]["model"][k] if k == "prototypes.table" \
                    else outs[0]["model"][k]
                assert torch.equal(v, ref), (r, k)
            assert all(torch.equal(v, outs[0]["bank"][k]) for k, v in out["bank"].items())
        if model > 1:
            assert not torch.equal(outs[0]["model"]["prototypes.table"],
                                   outs[1]["model"]["prototypes.table"])


def test_tower_reduced_over_the_world_stays_identical():
    """At (2 x 2), model rank 1's tower gradients scaled by 1 + 2^-20 (as a
    card kernel that sums in another order makes them differ in the last
    bits): the towers still end bit for bit the same on every rank, since
    the tower's gradients are meaned over every rank that holds it; each
    shard stays the same across its data group."""
    ranks = _ranks(2, 2)
    for step in range(STEPS):
        outs = [r["jittered"][step] for r in ranks]
        for r, out in enumerate(outs):
            for k, v in out["model"].items():
                ref = outs[r % 2]["model"][k] if k == "prototypes.table" else outs[0]["model"][k]
                assert torch.equal(v, ref), (r, k)
    # the jitter moved the state, within rounding of the unjittered step
    plain = ranks[0]["steps"][-1]["model"]
    jittered = ranks[0]["jittered"][-1]["model"]
    assert any(not torch.equal(plain[k], jittered[k]) for k in plain)
    for k in plain:
        torch.testing.assert_close(jittered[k], plain[k], rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", [0, 1], ids=["bn1d", "bn2d"])
def test_sync_batchnorm_over_the_data_group(case):
    """At (2 x 2) each rank normalizes its data rank's rows with statistics
    over its data group: the outputs and input gradients of data ranks 0
    and 1 joined, the sum of their weight and bias gradients, and the
    running statistics, against the port's BatchNorm and flax's on the
    whole batch within 1e-5; the model ranks of a row agree bit for bit."""
    ranks = [out["bn"][case] for out in _ranks(2, 2)]
    for d in range(2):
        for k, v in ranks[2 * d].items():
            assert torch.equal(v, ranks[2 * d + 1][k]), (d, k)
    rows = [ranks[0], ranks[2]]
    got = {"y": torch.cat([r["y"] for r in rows]), "dx": torch.cat([r["dx"] for r in rows]),
           "dw": sum(r["dw"] for r in rows), "db": sum(r["db"] for r in rows),
           "mean": rows[0]["mean"], "var": rows[0]["var"]}
    arrays = BN_CASES[case]
    one = th.batchnorm_case(*(torch.from_numpy(a) for a in arrays), sync=False)
    for want in (one, _flax_bn(*arrays)):
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=0, atol=1e-5,
                                       err_msg=k)


def test_model_axis_must_divide_k_and_the_world():
    with pytest.raises(ValueError, match="do not split over 3"):
        Prototypes(128, 16, 3, 0)
    with pytest.raises(ValueError, match="do not split over 3"):
        prototype_shard(np.zeros((128, 16)), 0, 3)
    # without a group the world is one rank
    with pytest.raises(ValueError, match="does not divide the world of 1"):
        mesh.set_model_parallel(2)
    mesh.set_model_parallel(1)
    assert mesh.model_size() == 1 and mesh.model_group() is None


@pytest.mark.parametrize("model", [2, 4])
def test_checkpoint_under_a_model_axis_raises(model):
    """`save_state` and `restore_state` refuse a model axis (rank 0 holds
    one shard, not the table) on every rank."""
    for out in _ranks(1, model):
        save, restore = out["checkpoint"]
        assert save and "model axis" in save
        assert restore and "model axis" in restore

