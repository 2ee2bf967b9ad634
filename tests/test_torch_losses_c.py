"""The port's ring buffer, MoCo, SwAV and SeLA losses and the heads of those
algorithms against the JAX package's, on the same numpy inputs, in float32
on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssv_tpu.models import heads as JH
from ssv_tpu.objectives import losses as JL
from ssv_tpu.state.banks import RingBuffer as JRing
from ssv_tpu.state.banks import ring_push as jax_ring_push
from ssv_tpu.train.base import apply_train, init_module
from ssv_tpu_torch.convert import mlp_state_dict
from ssv_tpu_torch.models import heads as TH
from ssv_tpu_torch.objectives import losses as TL
from ssv_tpu_torch.state.banks import RingBuffer, ring_push
from torch_helpers import t, to_numpy_tree

torch.set_num_threads(2)


def _unit(rs, n, d):
    z = rs.randn(n, d).astype(np.float32)
    return z / np.linalg.norm(z, axis=1, keepdims=True)


def _close(got, want, tol=1e-5):
    assert abs(got - want) <= tol * max(1.0, abs(want)), (got, want)


def _top_two_gap(x):
    s = np.sort(x, axis=-1)
    return s[..., -1] - s[..., -2]


@pytest.mark.parametrize("ptr,n", [(0, 3), (7, 5), (9, 4), (3, 23), (0, 10)],
                         ids=["inside", "straddle", "straddle-from-end", "exceed",
                              "exactly-size"])
def test_ring_push(ptr, n):
    """Pushes that stay inside, straddle the end, and exceed the size:
    data and pointer exactly as the JAX scatter leaves them."""
    rs = np.random.RandomState(n)
    size, dim = 10, 4
    data = rs.randn(size, dim).astype(np.float32)
    rows = rs.randn(n, dim).astype(np.float32)
    want = jax_ring_push(JRing(jnp.asarray(data), jnp.asarray(ptr, jnp.int32)),
                         jnp.asarray(rows))
    buf = RingBuffer(size, dim)
    buf.data.copy_(t(data))
    buf.ptr.fill_(ptr)
    ring_push(buf, t(rows))
    np.testing.assert_array_equal(buf.data.numpy(), np.asarray(want.data))
    assert int(buf.ptr) == int(want.ptr) == (ptr + n) % size


@pytest.mark.parametrize("normalize,temperature", [(True, 0.07), (False, 1.0)])
def test_moco_nce(normalize, temperature):
    """The queue rows go in as stored (not re-normalized), on both sides."""
    rs = np.random.RandomState(0)
    q, k = rs.randn(12, 16).astype(np.float32), rs.randn(12, 16).astype(np.float32)
    queue = 1.5 * _unit(rs, 40, 16)
    kw = dict(temperature=temperature, normalize=normalize)
    want = float(JL.moco_nce(q, k, queue, **kw))
    _close(TL.moco_nce(t(q), t(k), t(queue), **kw).item(), want)


@pytest.mark.parametrize("scale,eps,iters", [(1.0, 0.05, 3), (6.0, 0.05, 3), (1.0, 0.04, 30)],
                         ids=["swav", "s-over-eps-120", "sela-eps"])
def test_sinkhorn_codes(scale, eps, iters):
    """At SwAV's scores, at scores where s / eps reaches 120 (exp overflows
    float32 past 88; both sides stay finite in the log domain), and at
    SeLA's eps and iterations. Argmax labels equal where the JAX codes'
    top two differ by more than 1e-4."""
    rs = np.random.RandomState(1)
    scores = (scale * rs.uniform(-1, 1, (48, 20))).astype(np.float32)
    if scale > 1:
        assert np.abs(scores).max() / eps > 88
    want = np.asarray(JL.sinkhorn_codes(jnp.asarray(scores), eps, iters))
    got = TL.sinkhorn_codes(t(scores), eps, iters).numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    clear = _top_two_gap(want) > 1e-4
    assert clear.sum() > len(want) // 2
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


def test_sinkhorn_codes_carry_no_gradient():
    s = torch.randn(8, 5, requires_grad=True)
    assert not TL.sinkhorn_codes(s).requires_grad


@pytest.mark.parametrize("with_bank", [False, True])
def test_swav_loss(with_bank):
    rs = np.random.RandomState(2)
    z1, z2 = _unit(rs, 16, 8), _unit(rs, 16, 8)
    protos = _unit(rs, 30, 8)
    bank = _unit(rs, 24, 8) if with_bank else None
    kw = dict(temperature=0.1, sinkhorn_eps=0.05, sinkhorn_iters=3)
    want = float(JL.swav_loss(z1, z2, protos, bank_features=bank, **kw))
    tz1 = t(z1).requires_grad_(True)
    tbank = t(bank).requires_grad_(True) if with_bank else None
    got = TL.swav_loss(tz1, t(z2), t(protos), bank_features=tbank, **kw)
    _close(got.item(), want)
    got.backward()
    assert tz1.grad is not None
    if with_bank:
        assert tbank.grad is None


@pytest.mark.parametrize("lmbda", [25.0, 2.0])
def test_sela_self_label_threads_alpha_beta(lmbda):
    """Two batches, alpha and beta carried from the first to the second, as
    the sweep carries them; alpha and beta within 1e-5 relative (they are
    as small as 1e-18 at lambda 25, so an absolute bound would hold
    nothing). |log p| stays under 34.8, where log p ** 25 overflows float32
    on both sides. Labels equal where the scaled scores' top two differ by
    more than 1e-4 of the row's scale.

    beta starts positive, the sign it has after any first iteration. The
    N(0, 1) beta of the very first batch of a run mixes signs, and P beta
    then cancels: at this seed one row sums to 1/73 of its terms'
    magnitudes, so the two frameworks' last-bit differences in log_softmax,
    times 25 through the power, reach 7e-5 relative in alpha."""
    rs = np.random.RandomState(3)
    K, B, iters = 8, 12, 5
    alpha = rs.randn(K, 1).astype(np.float32)
    beta = np.abs(rs.randn(B, 1)).astype(np.float32)
    ja, jb, ta, tb = jnp.asarray(alpha), jnp.asarray(beta), t(alpha), t(beta)
    for batch in range(2):
        logits = rs.randn(B, K).astype(np.float32)
        logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
        assert np.abs(logp).max() < 34.8
        jl, ja, jb = JL.sela_self_label(jnp.asarray(logits), ja, jb, lmbda=lmbda,
                                        n_iters=iters)
        tl, ta, tb = TL.sela_self_label(t(logits), ta, tb, lmbda=lmbda, n_iters=iters)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=0,
                                   err_msg=f"alpha, batch {batch}")
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=0,
                                   err_msg=f"beta, batch {batch}")
        P = np.asarray(logp, np.float64).T ** lmbda
        scaled = (np.asarray(ja, np.float64) * P * np.asarray(jb, np.float64).T).T
        clear = _top_two_gap(scaled) > 1e-4 * np.abs(scaled).max(-1)
        assert clear.sum() > B // 2
        np.testing.assert_array_equal(tl.numpy()[clear], np.asarray(jl)[clear])


# -- heads ------------------------------------------------------------------

def _flax(module, x):
    params, bstats = init_module(jax.random.PRNGKey(0), module, jnp.asarray(x))
    out, new_stats = apply_train(module, params, bstats, jnp.asarray(x))
    return to_numpy_tree(params), to_numpy_tree(bstats), np.asarray(out), new_stats


def test_linear_head_forward():
    x = np.random.RandomState(4).randn(10, 32).astype(np.float32)
    params, bstats, want, _ = _flax(JH.LinearHead(16, dtype=jnp.float32), x)
    head = TH.LinearHead(32, 16)
    head.load_state_dict(mlp_state_dict(params, bstats, ()))
    got = head(t(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)


def test_swav_projection_forward():
    """fc-bn-gelu-fc-bn with the exact GELU and an L2 output, in train mode,
    and the BN statistics it leaves."""
    x = np.random.RandomState(5).randn(10, 32).astype(np.float32)
    params, bstats, want, new_stats = _flax(JH.swav_projection(24, 16, dtype=jnp.float32), x)
    head = TH.swav_projection(32, 24, 16)
    head.load_state_dict(mlp_state_dict(params, bstats, (0, 1)))
    got = head.train()(t(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    want_sd = mlp_state_dict(params, to_numpy_tree(new_stats), (0, 1))
    for k, v in head.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)


def test_prototypes_forward():
    module = JH.Prototypes(30, 8)
    params = module.init(jax.random.PRNGKey(0))["params"]
    want = np.asarray(module.apply({"params": params}))
    protos = TH.Prototypes(30, 8)
    protos.load_state_dict({"table": t(params["table"])})
    np.testing.assert_allclose(protos().detach().numpy(), want, rtol=0, atol=1e-5)


def test_cluster_heads_forward():
    """(batch, dim) -> (heads, batch, clusters), float32 even under
    autocast, as the flax heads take float32."""
    x = np.random.RandomState(6).randn(10, 32).astype(np.float32)
    module = JH.ClusterHeads(3, 8)
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    heads = TH.ClusterHeads(32, 3, 8)
    heads.load_state_dict({"kernel": t(params["kernel"]), "bias": t(params["bias"])})
    got = heads(t(x))
    assert got.shape == (3, 10, 8)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert heads(t(x)).dtype == torch.float32


@pytest.mark.parametrize("make_flax,make_port,name", [
    (lambda: JH.ClusterHeads(10, 128), lambda: TH.ClusterHeads(512, 10, 128), "kernel"),
    (lambda: JH.Prototypes(300, 128), lambda: TH.Prototypes(300, 128), "table"),
], ids=["cluster_heads", "prototypes"])
def test_head_init_scale(make_flax, make_port, name):
    """The port draws its own weights: at the scale of the flax initializer
    (the cluster kernel's lecun normal counts heads x dim inputs)."""
    x = jnp.zeros((2, 512))
    module = make_flax()
    args = () if name == "table" else (x,)
    want = np.asarray(module.init(jax.random.PRNGKey(0), *args)["params"][name]).std()
    port = make_port()
    port.init_weights(torch.Generator().manual_seed(0))
    got = getattr(port, name).detach().numpy().std()
    assert abs(got / want - 1) < 0.03, (got, want)
