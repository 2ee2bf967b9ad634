"""The ViT's attention core (`ops/attention.py`, `csrc/attention.cu`).

On the CPU `attention` is the composition the module ran before the
kernels, bit for bit: its output, the probabilities `return_attn` gives and
the gradients of q, k and v; so are `SelfAttention` (at 65 and 5 tokens,
padded keys, the fused QKV product) and the whole encoder, in bf16 and in
float32. The module sends the core to `attention` in bf16 with heads of 64
on sequences of up to 128 tokens and keeps the composition otherwise; the wrapper's checks
refuse what the kernels do not take. The tests marked `card` hold the
kernels to the composition and to a float64 computation on a CUDA card,
capture them in a CUDA graph and count their launches in a DINO step, and
skip without one; run them there with

    python -m pytest tests/test_torch_attention.py -m card --noconftest
"""

import math

import pytest
import torch
import torch.nn.functional as F

from ssv_tpu_torch.models import vit
from ssv_tpu_torch.ops import attention as A
from ssv_tpu_torch.utils import trace
from torch_helpers import card  # noqa: F401 (a fixture)

torch.set_num_threads(2)

HIDDEN, HEADS = 128, 2   # heads of 64, the kernels' width


def _old_core(q, k, v, valid_len, dt):
    """The attention core as `SelfAttention.forward` ran it before the
    kernels, from the (b, n, h, d) q, k and v."""
    b, n, h, d = q.shape
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(d)
    if valid_len is not None and valid_len < n:
        keep = torch.arange(n, device=q.device) < valid_len
        scores = scores.masked_fill(~keep, -1e9)
    probs = torch.softmax(scores, dim=-1)
    out = (probs.to(dt) @ v).transpose(1, 2).reshape(b, n, h * d)
    return out, probs


def _old_forward(self, x, dt, valid_len=None, return_attn=False):
    """`SelfAttention.forward` as it was before the kernels (it always gave
    the probabilities)."""
    b, n, _ = x.shape
    h = self.num_heads
    d = self.hidden_dim // h
    identity = vit._layer_norm(self.ln, x, dt)
    if self.fuse_qkv:
        w = torch.cat([self.query.weight, self.key.weight, self.value.weight]).to(dt)
        q, k, v = F.linear(x, w).reshape(b, n, 3, h, d).unbind(2)
    else:
        q, k, v = (vit._linear(fc, x, dt).reshape(b, n, h, d)
                   for fc in (self.query, self.key, self.value))
    out, probs = _old_core(q, k, v, valid_len, dt)
    return out + identity, probs


def _qkv(b, n, dtype=torch.bfloat16, h=HEADS, d=64, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return [(1.5 * torch.randn(b, n, h, d, generator=g)).to(dtype).to(device)
            for _ in range(3)]


def _leaves(*ts):
    return [t.detach().clone().requires_grad_() for t in ts]


# --------------------------------------------------------------------------
# CPU: the composition, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,valid_len", [(65, None), (5, None), (72, 65), (8, 5)])
@pytest.mark.parametrize("return_attn", [True, False])
def test_attention_is_the_composition(n, valid_len, return_attn):
    """`attention` on CPU tensors: the output, the probabilities where asked
    (None otherwise) and the gradients of q, k and v equal the old core's."""
    q, k, v = _qkv(3, n)
    qa, ka, va = _leaves(q, k, v)
    qb, kb, vb = _leaves(q, k, v)
    got, probs = A.attention(qa, ka, va, valid_len, return_attn)
    want, want_probs = _old_core(qb, kb, vb, valid_len, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    if return_attn:
        assert probs.dtype == torch.float32 and torch.equal(probs, want_probs)
    else:
        assert probs is None
    gy = torch.randn(got.shape, generator=torch.Generator().manual_seed(4)).bfloat16()
    got.backward(gy)
    want.backward(gy)
    for a, b in ((qa, qb), (ka, kb), (va, vb)):
        assert torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fuse_qkv", [False, True], ids=["qkv", "fused-qkv"])
@pytest.mark.parametrize("n,valid_len", [(65, None), (5, None), (72, 65), (8, 5)])
def test_self_attention_is_the_old_module(n, valid_len, fuse_qkv, dtype):
    """`SelfAttention` with the wrapper routed in, against its old forward
    from the same weights: the output, the probabilities and the gradients
    of the input and of every parameter, bit for bit."""
    torch.manual_seed(0)
    new = vit.SelfAttention(HIDDEN, HEADS, fuse_qkv)
    old = vit.SelfAttention(HIDDEN, HEADS, fuse_qkv)
    old.load_state_dict(new.state_dict())
    x = torch.randn(3, n, HIDDEN, generator=torch.Generator().manual_seed(1)).to(dtype)
    xa, xb = _leaves(x, x)
    got, probs = new(xa, dtype, valid_len, return_attn=True)
    want, want_probs = _old_forward(old, xb, dtype, valid_len)
    assert torch.equal(got, want) and torch.equal(probs, want_probs)
    assert new(x, dtype, valid_len)[1] is None
    gy = torch.randn(got.shape, generator=torch.Generator().manual_seed(2)).to(dtype)
    got.backward(gy)
    want.backward(gy)
    assert torch.equal(xa.grad, xb.grad)
    for (name, a), b in zip(new.named_parameters(), old.parameters()):
        assert torch.equal(a.grad, b.grad), name


@pytest.mark.parametrize("cfg", [{}, {"seq_pad_multiple": 8, "fuse_qkv": True}],
                         ids=["plain", "padded-fused"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_encoder_is_the_old_encoder(cfg, dtype, monkeypatch):
    """The ViT (two layers of two heads of 64) on global and local crops,
    against the same weights run with the old `SelfAttention.forward`: the
    CLS output, `return_attn`'s maps (padded rows and columns cut) and every
    parameter's gradient, bit for bit."""
    torch.manual_seed(0)
    net = vit.TransformerEncoder(HIDDEN, 32, 96, HEADS, 4, 2, 64, 4, dtype=dtype, **cfg)
    net.init_weights(torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(5)
    for size in (32, 8):
        img = torch.rand(2, size, size, 3, generator=g)

        def run():
            net.zero_grad()
            cls, attn = net(img, return_attn=True)
            cls.square().sum().backward()
            return cls, attn, [p.grad for p in net.parameters()]

        got = run()
        with monkeypatch.context() as m:
            m.setattr(vit.SelfAttention, "forward", _old_forward)
            want = run()
        assert torch.equal(got[0], want[0])
        assert got[1].keys() == want[1].keys()
        for key in want[1]:
            assert torch.equal(got[1][key], want[1][key]), key
            assert got[1][key].shape[-1] == (size // 4) ** 2 + 1
        for a, b in zip(got[2], want[2]):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("dtype,n,hidden,heads,routed",
                         [(torch.bfloat16, 65, HIDDEN, HEADS, True),
                          (torch.bfloat16, 5, HIDDEN, HEADS, True),
                          (torch.bfloat16, 128, HIDDEN, HEADS, True),
                          (torch.float32, 65, HIDDEN, HEADS, False),
                          (torch.bfloat16, 129, HIDDEN, HEADS, False),
                          (torch.bfloat16, 65, 32, 4, False),
                          (torch.bfloat16, 5, 32, 4, False),
                          (torch.bfloat16, 65, 64, 2, False)],
                         ids=["bf16-65", "bf16-5", "bf16-128", "f32-65", "bf16-129",
                              "bf16-65-d8", "bf16-5-d8", "bf16-65-d32"])
def test_module_routes_by_dtype_and_length(dtype, n, hidden, heads, routed, monkeypatch):
    """The module sends the core to `attention` in bf16 with heads of 64 on
    up to 128 tokens, and keeps the composition (`attention_reference`) for
    float32, for longer sequences and for heads of another width (the sweep's
    small DINO encoder has heads of 8)."""
    calls = []

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return A.attention(*args, **kw)

    monkeypatch.setattr(vit, "attention", spy)
    layer = vit.SelfAttention(hidden, heads)
    x = torch.randn(2, n, hidden).to(dtype)
    with torch.no_grad():
        out, _ = layer(x, dtype)
        want, _ = _old_forward(layer, x, dtype)
    assert torch.equal(out, want)
    assert calls == ([(2, n, heads, hidden // heads)] if routed else [])


def test_cpu_counts_no_launch():
    before = trace.counters.get("attention.launches", 0)
    q, k, v = _qkv(2, 65)
    A.attention(q, k, v)
    assert trace.counters.get("attention.launches", 0) == before
    assert "attention.launches" in trace.LAUNCHES


def _strided(b, n, width):
    """(b, n, 2, 64) views of a (b, n, width) bf16 buffer, three of them."""
    base = torch.zeros(b, n, width, dtype=torch.bfloat16)
    return [base[..., i * 128:(i + 1) * 128].unflatten(-1, (2, 64)) for i in range(3)]


REFUSED = {
    "float32": (lambda: _qkv(2, 65, torch.float32), 65, "bf16"),
    "float16": (lambda: _qkv(2, 65, torch.float16), 65, "bf16"),
    "head-32": (lambda: _qkv(2, 65, h=4, d=32), 65, "head width"),
    "tokens-129": (lambda: _qkv(2, 129), 129, "sequence length"),
    "shapes": (lambda: _qkv(2, 65)[:2] + _qkv(2, 64)[2:], 65, "one shape"),
    "row-stride": (lambda: _strided(2, 65, 3 * 128 + 4), 65, "multiples of 8"),
    "head-stride": (lambda: [t.transpose(1, 2).contiguous().transpose(1, 2)
                             for t in _qkv(2, 65)], 65, "strides"),
    "strides-differ": (lambda: _qkv(2, 65)[:2] + _strided(2, 65, 3 * 128)[2:], 65, "share"),
    "valid-0": (lambda: _qkv(2, 65), 0, "valid_len"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_checks_refuse_what_the_kernels_do_not_take(case):
    make, valid, match = REFUSED[case]
    q, k, v = make()
    with pytest.raises(ValueError, match=match):
        A._check_layout(q, k, v, valid)


def test_checks_take_the_main_paths_layouts():
    """The Linear outputs' views, the fused product's strided views and a
    padded sequence pass."""
    for q, k, v in (_qkv(3, 65), _qkv(8, 5), _strided(2, 72, 3 * 128)):
        A._check_layout(q, k, v, 65 if q.shape[1] == 72 else q.shape[1])


def test_a_device_neither_cpu_nor_cuda_raises():
    q, k, v = (t.to("meta") for t in _qkv(2, 65))
    with pytest.raises(ValueError, match="unsupported device"):
        A.attention(q, k, v)


def test_attention_bytes_counts_each_tensor_once():
    q = torch.empty(256, 65, 6, 64, dtype=torch.bfloat16)
    t = 256 * 65 * 384 * 2
    assert A.attention_bytes(q) == 11 * t
    assert A.attention_bytes(q, backward=False) == 4 * t


def test_autograd_function_keeps_what_the_backward_needs(monkeypatch):
    """`_Attention` with its two launches stood in for by plain PyTorch on
    the CPU: the forward saves q, k, v and the log-sum-exp, the backward
    gets the output's gradient (contiguous, bf16) and returns q's, k's and
    v's; the probabilities pass as an output without a gradient, or None."""
    seen = {}

    def forward(q, k, v, valid, with_lse, with_probs):
        out, probs = _old_core(q, k, v, valid, q.dtype)
        return out, probs.logsumexp(-1) if with_lse else None, probs if with_probs else None

    def backward(q, k, v, g, lse, valid):
        seen.update(g=g, lse=lse, valid=valid)
        qs, ks, vs = _leaves(q, k, v)
        with torch.enable_grad():
            out, _ = _old_core(qs, ks, vs, valid, q.dtype)
        return torch.autograd.grad(out, (qs, ks, vs), g)

    monkeypatch.setattr(A, "_forward", forward)
    monkeypatch.setattr(A, "_backward", backward)
    q, k, v = _qkv(2, 72)
    for return_attn in (True, False):
        qa, ka, va = _leaves(q, k, v)
        out, probs = A._Attention.apply(qa, ka, va, 65, return_attn)
        assert (probs is not None) == return_attn
        assert probs is None or not probs.requires_grad
        gy = torch.randn(out.shape).bfloat16().transpose(0, 1).contiguous().transpose(0, 1)
        assert not gy.is_contiguous()
        out.backward(gy)
        assert seen["g"].is_contiguous() and seen["valid"] == 65
        assert seen["lse"].shape == (2, HEADS, 72)
        qb, kb, vb = _leaves(q, k, v)
        want, _ = _old_core(qb, kb, vb, 65, torch.bfloat16)
        want.backward(gy)
        for a, b in ((qa, qb), (ka, kb), (va, vb)):
            assert torch.equal(a.grad, b.grad)


# --------------------------------------------------------------------------
# the card: the kernels against the composition and float64
# --------------------------------------------------------------------------

def _card_qkv(b, n, fused, card, seed=0):
    """q, k, v (b, n, 6, 64) bf16 as the Linear outputs' views, or the fused
    product's strided ones, and an output gradient."""
    g = torch.Generator(device=card).manual_seed(seed)
    if fused:
        q, k, v = (1.5 * torch.randn(b, n, 3, 6, 64, device=card, generator=g)).bfloat16().unbind(2)
    else:
        q, k, v = ((1.5 * torch.randn(b, n, 384, device=card, generator=g)).bfloat16()
                   .unflatten(-1, (6, 64)) for _ in range(3))
    return q, k, v, torch.randn(b, n, 384, device=card, generator=g).bfloat16()


def _float64(q, k, v, valid_len):
    """The same attention in float64, nothing rounded: (output,
    probabilities)."""
    b, n, h, d = q.shape
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    scores = q @ k.transpose(-1, -2) / math.sqrt(d)
    if valid_len is not None and valid_len < n:
        scores = scores.masked_fill(torch.arange(n, device=q.device) >= valid_len, -1e9)
    probs = scores.softmax(-1)
    return (probs @ v).transpose(1, 2).reshape(b, n, h * d), probs


def _through(fn, q, k, v, valid_len, gy):
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    out, probs = fn(qs, ks, vs, valid_len)
    return out, probs, torch.autograd.grad(out, (qs, ks, vs), gy)


def _err(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


# the main path's calls: the global crops (256 sequences of 65 tokens), the
# local crops (768 of 5), the global crops padded to 72 with 65 valid, and
# the fused QKV product's strides
CARD_CASES = [(256, 65, None, False), (768, 5, None, False), (256, 72, 65, False),
              (256, 65, None, True)]


@pytest.mark.card
@pytest.mark.parametrize("b,n,valid_len,fused", CARD_CASES)
def test_card_kernels_are_no_less_precise_than_the_composition(b, n, valid_len, fused, card):
    """Forward and backward through the kernels and through
    `attention_reference`, each against float64 from the same bf16 inputs.
    Both round the output, P for P @ V and dq, dk and dv to bf16 once; they
    differ in the order of their sums, in the composition's dP rounded to
    bf16, and in the kernels' dS as bf16 hi + lo (16 bits, where the
    composition keeps float32). Held: each of the output, the probabilities
    and dq, dk and dv at most 1.25 times the composition's error by norm
    plus 1e-6 (readings: the output and dv equal to the composition's, about
    2.3e-3, the last bf16 rounding; dq and dk 1.66e-3 against 2.35e-3; the
    float32 probabilities, another exp and order of the sum, 1.1 times the
    composition's 1.1e-7), and the kernels within 1e-2 of the composition
    (the gradients part by 2.7e-3). The forward and backward launch one
    kernel each."""
    q, k, v, gy = _card_qkv(b, n, fused, card)
    before = trace.counters.get("attention.launches", 0)
    got = _through(lambda *a: A.attention(*a, return_attn=True), q, k, v, valid_len, gy)
    assert trace.counters["attention.launches"] - before == 2
    ref = _through(A.attention_reference, q, k, v, valid_len, gy)
    exact = _through(_float64, q.double(), k.double(), v.double(), valid_len, gy.double())
    torch.cuda.synchronize()
    names = ("output", "probs", "dq", "dk", "dv")
    flat = [(name, g, r, e) for name, g, r, e in zip(
        names, got[:2] + got[2], ref[:2] + ref[2], exact[:2] + exact[2])]
    lines = []
    for name, g, r, e in flat:
        assert torch.isfinite(g).all(), name
        kern, comp, apart = _err(g, e), _err(r, e), _err(g, r)
        lines.append(f"{name} {kern:.3e} (composition {comp:.3e}, apart {apart:.3e})")
        assert kern <= 1.25 * comp + 1e-6, (name, kern, comp)
        assert apart <= 1e-2, (name, apart)
    print(f"attention ({b}, {n}) valid {valid_len} fused {fused} against float64: "
          + "; ".join(lines))


@pytest.mark.card
@pytest.mark.parametrize("b,n,valid_len,fused", CARD_CASES[:3])
def test_card_forward_without_grad_is_the_recorded_one(b, n, valid_len, fused, card):
    """The teacher's forward (no gradient: one launch, no log-sum-exp) gives
    the recorded forward's output bit for bit; `return_attn`'s
    probabilities are the same either way, rows summing to 1."""
    q, k, v, _ = _card_qkv(b, n, fused, card)
    before = trace.counters.get("attention.launches", 0)
    with torch.no_grad():
        out, probs = A.attention(q, k, v, valid_len, return_attn=True)
        plain, none = A.attention(q, k, v, valid_len)
    assert trace.counters["attention.launches"] - before == 2 and none is None
    rec, rec_probs = A.attention(*_leaves(q, k, v), valid_len, return_attn=True)
    assert rec.grad_fn is not None and out.grad_fn is None
    assert torch.equal(out, rec.detach()) and torch.equal(plain, out)
    assert torch.equal(probs, rec_probs)
    assert (probs.sum(-1) - 1).abs().max() <= 1e-5
    if valid_len is not None:
        assert (probs[..., valid_len:] == 0).all()


@pytest.mark.card
def test_card_refuses_what_the_kernels_do_not_take(card):
    q, k, v, _ = _card_qkv(4, 65, False, card)
    for args in ((q.float(), k.float(), v.float()),
                 [t.reshape(4, 65, 12, 32) for t in (q, k, v)],
                 [torch.zeros(4, 129, 6, 64, dtype=torch.bfloat16, device=card)] * 3):
        with pytest.raises(ValueError):
            A.attention(*args)


@pytest.mark.card
def test_card_graph_replay_is_eager(card):
    """A CUDA graph of forward and backward at the global crops' shape
    replays the eager call's output and gradients bit for bit (no atomics:
    every sum in a fixed order)."""
    q, k, v, gy = _card_qkv(256, 65, False, card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    leaves = _leaves(q, k, v)

    def step():
        out, _ = A.attention(*leaves)
        return (out,) + torch.autograd.grad(out, leaves, gy)

    with torch.cuda.stream(side):
        eager = [t.clone() for t in step()]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            held = step()
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(held, eager):
            assert torch.equal(a, b)


@pytest.mark.card
def test_card_dino_step_launches_thirty(card, tmp_path):
    """DINO's step on the shipped ViT (6 layers; batch 64: the teacher over
    the 256 global crops, the student over those and the 768 local crops)
    launches 18 forward kernels (3 calls x 6 layers) and 12 backward ones:
    30 a step in the warm-up steps and in the graph's replays."""
    import yaml

    from ssv_tpu_torch.train import graph as graph_mod
    from ssv_tpu_torch.train.trainer import Trainer

    with open("configs/dino.yaml") as f:
        assert yaml.safe_load(f)["encoder"]["num_encoder_layers"] == 6
    trainer = Trainer({"config": "configs/dino.yaml", "algo": "dino", "arch": "vit",
                       "task": "train", "output": "attn"},
                      overrides={"data": {"batch_size": 64}},
                      synthetic_sizes=(64 * 6, 64), make_dirs=False)
    state = trainer.algorithm.pre_train(trainer.state, trainer)
    trainer.begin_epoch(trainer.epoch_indices())
    steps = graph_mod.WARMUP_STEPS + 2
    before = trace.counters.get("attention.launches", 0)
    for _ in range(steps):
        trainer.step(state)
    torch.cuda.synchronize()
    assert trainer.epoch_mode == "graph" and trainer.graph.replays == 2
    assert trainer.graph.held["attention.launches"] == 30
    assert trace.counters["attention.launches"] - before == 30 * steps
