"""The port's data-parallel pieces (ssv_tpu_torch/parallel/) across ranks:
spawned CPU processes on gloo, one thread each, every spawn joined within
`torch_helpers.RANK_TIMEOUT_S`.

  * the gradient-reduction rule, on the JAX package's two toy losses
    (tests/test_per_device_bn.py), at 2 and 4 ranks: the reduced step
    equals the single-process step within 1e-6;
  * the sync BatchNorm at 2 and 4 ranks, 1d and 2d: output, input, weight
    and bias gradients and the running mean and biased variance equal the
    port's BatchNorm and flax's `nn.BatchNorm` on the whole batch within
    1e-5;
  * a 1-rank group runs the SimCLR steps bit for bit as no group does;
  * the JAX package's psum rule for a loss of gathered rows steps by the
    world size times the gradient, where the port's mean does not.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import torch_helpers as th

torch.set_num_threads(2)

TOY_X = np.arange(16, dtype=np.float32) + 1.0


@functools.cache
def _toy(world):
    return th.run_ranks(th.rank_toy_reduction, world, TOY_X)


@pytest.mark.parametrize("gathered", [False, True], ids=["local-mean", "global-gathered"])
@pytest.mark.parametrize("world", [2, 4])
def test_reduction_rule_matches_the_single_process_step(world, gathered):
    """Every rank's w after the step, and its loss metric, equal the
    single-process step's: the mean of the ranks' gradients is right for
    both loss scopes (`parallel/per_device.py` derives why)."""
    w_one, loss_one = th.toy_reduction_steps(torch.from_numpy(TOY_X), gathered)
    assert float(w_one) != 1.0   # the step moved w
    for out in _toy(world):
        w, loss = out[gathered]
        np.testing.assert_allclose(float(w), float(w_one), rtol=1e-6)
        np.testing.assert_allclose(float(loss), float(loss_one), rtol=1e-6)


def _bn_cases():
    rs = np.random.RandomState(0)
    cases = []
    for shape in ((16, 5), (8, 3, 4, 4)):
        x = (rs.randn(*shape) * 3 + 1).astype(np.float32)
        cases.append((x, rs.randn(*shape).astype(np.float32),
                      (rs.rand(shape[1]) + 0.5).astype(np.float32),
                      rs.randn(shape[1]).astype(np.float32)))
    return cases


BN_CASES = _bn_cases()


@functools.cache
def _bn(world):
    return th.run_ranks(th.rank_batchnorm, world, BN_CASES)


def _flax_bn(x, upstream, weight, bias):
    """flax BatchNorm (momentum 0.9, eps 1e-5) on the whole batch, channels
    last: output, gradients of sum(y * upstream), new running statistics."""
    nhwc = x.ndim == 4
    to_last = (lambda a: np.moveaxis(a, 1, -1)) if nhwc else (lambda a: a)
    xl, ul = jnp.asarray(to_last(x)), jnp.asarray(to_last(upstream))
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    c = x.shape[1]
    stats = {"mean": jnp.full((c,), 0.5), "var": jnp.full((c,), 2.0)}

    def f(params, xx):
        y, upd = bn.apply({"params": params, "batch_stats": stats}, xx,
                          mutable=["batch_stats"])
        return jnp.sum(y * ul), (y, upd["batch_stats"])

    params = {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)}
    (_, (y, new)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, xl)
    back = (lambda a: np.moveaxis(np.asarray(a), -1, 1)) if nhwc else np.asarray
    return {"y": back(y), "dx": back(gx), "dw": np.asarray(gp["scale"]),
            "db": np.asarray(gp["bias"]), "mean": np.asarray(new["mean"]),
            "var": np.asarray(new["var"])}


@pytest.mark.parametrize("case", [0, 1], ids=["bn1d", "bn2d"])
@pytest.mark.parametrize("world", [2, 4])
def test_sync_batchnorm_matches_the_whole_batch(world, case):
    """The ranks' outputs and input gradients, concatenated, the sum of
    their weight and bias gradients (each rank's share of the whole
    batch's), and the running statistics of every rank, against the port's
    BatchNorm and flax's on the whole batch, within 1e-5."""
    arrays = BN_CASES[case]
    ranks = [out[case] for out in _bn(world)]
    got = {"y": torch.cat([r["y"] for r in ranks]), "dx": torch.cat([r["dx"] for r in ranks]),
           "dw": sum(r["dw"] for r in ranks), "db": sum(r["db"] for r in ranks)}
    one = th.batchnorm_case(*(torch.from_numpy(a) for a in arrays), sync=False)
    flax_out = _flax_bn(*arrays)
    for r in ranks:
        for k in ("mean", "var"):
            assert torch.equal(r[k], ranks[0][k])
            got[k] = r[k]
    for want in (one, flax_out):
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=0, atol=1e-5,
                                       err_msg=k)
    # the biased variance (flax's), not torch's unbiased one
    n = arrays[0].size // arrays[0].shape[1]
    biased = arrays[0].swapaxes(0, 1).reshape(arrays[0].shape[1], -1).var(axis=1)
    np.testing.assert_allclose(got["var"].numpy(), 0.9 * 2.0 + 0.1 * biased, rtol=1e-5)
    assert n > 1


def test_one_rank_group_equals_no_group():
    """Three float32 SimCLR steps of a small ResNet on the same views, in one
    process: without a group, then under a 1-rank gloo group; the losses
    and the state bit for bit."""
    out, = th.run_ranks(th.rank_one_vs_no_group, 1)
    assert out["no_group"]["losses"] == out["group"]["losses"]
    assert all(np.isfinite(out["group"]["losses"]))
    th.assert_ranks_identical([out["no_group"], out["group"]])


@pytest.mark.parametrize("world", [2, 4])
def test_jax_global_psum_is_the_gradient_times_the_world(world):
    """The JAX package's per-device rule for a loss of gathered rows (psum
    of the gradients) steps by `world` times the single-device gradient
    (its all_gather's transpose already sums the replicas' cotangents),
    where the port's mean steps by the gradient itself: the toy global loss
    from w = 1."""
    import optax
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from ssv_tpu.parallel.mesh import get_mesh
    from ssv_tpu.train.base import Algorithm, TrainState

    algo = Algorithm.__new__(Algorithm)
    algo.tx = optax.sgd(1.0)
    w0 = jnp.ones(())
    state = TrainState(jnp.zeros((), jnp.int32), w0, {}, algo.tx.init(w0), {})
    x = jnp.asarray(TOY_X)

    def sync_loss(w):
        z = w * x
        return jnp.mean(z * jnp.sum(z)), {}

    def local(state, xs):
        def loss_fn(w):
            z = lax.all_gather(w * xs, "data", axis=0, tiled=True)
            return jnp.mean(z * jnp.sum(z)), {}
        return algo.grad_step(state, loss_fn, axis="data", loss_scope="global")[0]

    p_sync = float(algo.grad_step(state, sync_loss)[0])
    p_psum = float(jax.shard_map(local, mesh=get_mesh(world), in_specs=(P(), P("data")),
                                 out_specs=P(), check_vma=False)(state, x))
    np.testing.assert_allclose(p_psum - 1.0, world * (p_sync - 1.0), rtol=1e-6)
    w_port = float(_toy(world)[0][True][0])
    np.testing.assert_allclose(w_port, p_sync, rtol=1e-6)
