"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Each test makes its inputs with numpy from a seed, runs the JAX function and
the port's counterpart on them, and compares the results as numpy arrays.
Weights move from the JAX side to the port through ssv_tpu_torch/convert.py.

JAX is imported inside the functions that use it: the rank processes the
data-parallel tests spawn (`run_ranks`) import this module and run only the
port.
"""

import importlib.util
import os
import pickle
import tempfile
import time

import numpy as np
import torch


def to_numpy_tree(tree):
    """A flax variable tree (nested dicts of JAX arrays) as numpy arrays."""
    import jax

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
    import jax

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


# ---------------------------------------------------------------------------
# data-parallel tests: ranks as spawned CPU processes on gloo
# ---------------------------------------------------------------------------
RANK_TIMEOUT_S = 120   # a spawn's join, and each collective's wait


def start_group(rank, world, tmp, name="group", model_parallel=1):
    """Starts a gloo group of `world` ranks through a file under `tmp`,
    laid out as (world / model_parallel, model_parallel)."""
    from ssv_tpu_torch.parallel import mesh

    mesh.init("cpu", backend="gloo", init_method=f"file://{os.path.join(tmp, name)}",
              rank=rank, world_size=world, timeout_s=RANK_TIMEOUT_S,
              model_parallel=model_parallel)


def _rank_main(rank, fn, world, tmp, args):
    from ssv_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    try:
        out = fn(rank, world, tmp, *args)
    finally:
        mesh.destroy()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def run_ranks(fn, world, *args, timeout=RANK_TIMEOUT_S):
    """Runs fn(rank, world, tmp, *args) in `world` spawned processes (one
    thread each) and returns their results in rank order. `fn` starts its
    group with `start_group(rank, world, tmp)`. A rank that raises fails
    the call with its traceback; ranks still running after `timeout`
    seconds are killed and the call fails."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank_main, args=(fn, world, tmp, args), nprocs=world,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{fn.__name__} at {world} ranks did not end "
                                   f"within {timeout} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
                for r in range(world)]


def _toy_state(model):
    """A TrainState of `model` under plain SGD at lr 1 (the JAX test's
    `optax.sgd(1.0)`)."""
    from ssv_tpu_torch.train.base import TrainState

    opt = torch.optim.SGD(model.parameters(), lr=1.0)
    return TrainState(model, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0))


def _toy_algorithm():
    from ssv_tpu_torch.train.base import Algorithm

    algo = Algorithm.__new__(Algorithm)
    algo.per_device_bn = False
    return algo


def toy_reduction_steps(x, gathered):
    """One `grad_step` of w (from 1) on the rank's slice of x (16,): a local
    per-sample mean loss, mean(w x + x^2), or, `gathered`, mean(z sum(z))
    over z = pgather(w x), the same on every rank (the JAX tests'
    `test_local_mean_loss_grads_pmean_matches_sync` and
    `test_global_gathered_loss_grads_psum_matches_sync`). Returns (w after
    the step, the loss metric)."""
    from ssv_tpu_torch.parallel import batch_slice, pgather

    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.ones((), dtype=x.dtype))
    state = _toy_state(model)
    xs = batch_slice(x)
    if gathered:
        z = pgather(model.w * xs)
        loss, scope = (z * z.sum()).mean(), "global"
    else:
        loss, scope = (model.w * xs + xs ** 2).mean(), "local"
    state, metric = _toy_algorithm().grad_step(state, loss, loss_scope=scope)
    return model.w.detach().clone(), metric.clone()


def rank_toy_reduction(rank, world, tmp, x):
    start_group(rank, world, tmp)
    return {g: toy_reduction_steps(torch.from_numpy(x), g) for g in (False, True)}


def batchnorm_case(x, upstream, weight, bias, sync):
    """The port's BatchNorm (1d for (N, C), 2d for (N, C, H, W)) in train
    mode on the rank's slice of x, starting from running mean 0.5 and
    variance 2; backward of sum(y * upstream) over the slice. Returns the
    output, input gradient, weight and bias gradients (this rank's share)
    and the running statistics."""
    from ssv_tpu_torch.models.resnet import BatchNorm1d, BatchNorm2d
    from ssv_tpu_torch.parallel import batch_slice

    c = x.shape[1]
    bn = (BatchNorm1d if x.dim() == 2 else BatchNorm2d)(c)
    bn.sync = sync
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
        bn.running_mean.fill_(0.5)
        bn.running_var.fill_(2.0)
    xs = batch_slice(x).clone().requires_grad_(True)
    y = bn.train()(xs)
    (y * batch_slice(upstream)).sum().backward()
    return {"y": y.detach(), "dx": xs.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
            "mean": bn.running_mean.clone(), "var": bn.running_var.clone()}


def rank_batchnorm(rank, world, tmp, cases):
    start_group(rank, world, tmp)
    return [batchnorm_case(*(torch.from_numpy(a) for a in arrays), sync=True)
            for arrays in cases]


def use_small_resnet(arch="resnet18"):
    """`small_resnet18`'s two-stage ResNet in the port's registry alone, for
    a rank process (which imports no JAX)."""
    from ssv_tpu_torch.models import registry as torch_registry
    from ssv_tpu_torch.models import resnet as TR

    block = getattr(TR, {"resnet18": "BasicBlock", "resnet50": "Bottleneck"}[arch])
    torch_registry.NETWORKS[arch] = {
        "net": lambda **kw: TR.ResNet(block, SMALL_STAGES, **kw),
        "dim": 128 * block.expansion}


def _as_batch(batch):
    from ssv_tpu_torch.parallel import batch_slice

    return {k: batch_slice(torch.from_numpy(np.asarray(v)))
            .to(torch.int64 if k in ("idx", "index") else None) for k, v in batch.items()}


def algorithm_steps(case, rank=0):
    """The port's steps of one case (see tests/test_torch_parallel_algos.py):
    the algorithm built from `case["cfg"]`, the state loaded from
    `case["init"]` ({module name: state_dict}), each global batch of
    `case["batches"]` sliced for this rank, PIRL's draws injected (one per
    step, or one per step and rank), DINO's epoch EMA after the steps.
    Returns the loss metrics and the final state dicts."""
    from ssv_tpu_torch.train.base import DataInfo
    from ssv_tpu_torch.train.registry import build_algorithm

    use_small_resnet()
    algo = build_algorithm(case["algo"], case["cfg"], case["arch"], DataInfo(*case["info"]),
                           "cpu")
    state = algo.init_state(torch.Generator().manual_seed(0))
    for name, sd in case["init"].items():
        (state.model if name == "model" else state.extra[name]).load_state_dict(sd)
    losses = []
    for s, batch in enumerate(case["batches"]):
        draws = case.get("draws")
        if draws is not None:
            perm, neg = draws[s] if isinstance(draws[s], tuple) else draws[s][rank]
            algo.draw = (lambda g, bank, i, p=perm, n=neg:
                         (torch.from_numpy(p), bank.data[torch.from_numpy(n)]))
        state, metrics = algo.train_step(state, _as_batch(batch), None)
        losses.append(metrics["loss"].item())
    if case["algo"] == "dino":
        state = algo.post_epoch(state, 1)
    return {"losses": losses, "step": state.step, "model": state.model.state_dict(),
            "extra": {k: m.state_dict() for k, m in state.extra.items()}}


def rank_algorithm_steps(rank, world, tmp, cases):
    start_group(rank, world, tmp)
    return {name: algorithm_steps(case, rank) for name, case in cases.items()}


def load_state_dicts(tstate, result):
    """Loads `algorithm_steps`' final state dicts into a port TrainState."""
    tstate.model.load_state_dict(result["model"])
    for k, sd in result["extra"].items():
        tstate.extra[k].load_state_dict(sd)
    tstate.step = result["step"]
    return tstate


def assert_ranks_identical(results):
    """Every rank's state dicts equal rank 0's, bit for bit."""
    first = results[0]
    for r, res in enumerate(results[1:], start=1):
        for name in ("model", *first["extra"]):
            a = first["model"] if name == "model" else first["extra"][name]
            b = res["model"] if name == "model" else res["extra"][name]
            assert a.keys() == b.keys()
            for k in a:
                assert torch.equal(a[k], b[k]), f"rank {r} {name}.{k} differs from rank 0's"


def simclr_case(steps=3, batch=8, size=16):
    """SimCLR on the small ResNet, float32, on given views (numpy, seeded)."""
    import helpers

    cfg = helpers.mini_config("simclr", batch_size=batch)
    cfg["compute_dtype"] = "float32"
    cfg["optimizer"]["lr"] = 0.003
    rs = np.random.RandomState(0)
    batches = [{k: rs.randn(batch, size, size, 3).astype(np.float32)
                for k in ("aug_1", "aug_2")} for _ in range(steps)]
    return {"algo": "simclr", "cfg": cfg, "arch": "resnet18", "info": (10, 64, batch, 8),
            "init": {}, "batches": batches}


def rank_one_vs_no_group(rank, world, tmp):
    case = simclr_case()
    out = {"no_group": algorithm_steps(case)}
    start_group(rank, world, tmp)
    out["group"] = algorithm_steps(case)
    return out


# ---------------------------------------------------------------------------
# the model axis (tests/test_torch_parallel_tp.py): ranks laid out as
# (data, model), SwAV's prototype table sharded over the model group
# ---------------------------------------------------------------------------
def tp_layout():
    """This rank's place in the grid, its groups' ranks, and a sum of the
    world ranks over each group (the groups carry collectives)."""
    import torch.distributed as dist

    from ssv_tpu_torch.parallel import mesh, per_device

    r = mesh.rank()
    data, model = mesh.data_group(), mesh.model_group()
    one = torch.tensor([float(r)])
    return {"rank": r, "data": (mesh.data_rank(), mesh.data_size()),
            "model": (mesh.model_rank(), mesh.model_size()),
            "data_group": dist.get_process_group_ranks(data or dist.group.WORLD),
            "model_group": dist.get_process_group_ranks(model) if model else [r],
            "data_sum": per_device.all_reduce_sum(one).item(),
            "model_sum": per_device.group_sum(one, model).item() if model else float(r)}


def tp_loss(case):
    """SwAV's loss and Sinkhorn codes on this rank's shard of the
    (normalized) prototypes across the model group: the loss, the codes of
    view 1's scores (this rank's columns), and the gradients of z1, z2 and
    the shard."""
    from ssv_tpu_torch.convert import prototype_shard
    from ssv_tpu_torch.objectives.losses import sinkhorn_codes, swav_loss
    from ssv_tpu_torch.parallel import mesh

    group, cfg = mesh.model_group(), case["cfg"]
    z1, z2 = (torch.from_numpy(case[k]).requires_grad_(True) for k in ("z1", "z2"))
    protos = torch.from_numpy(prototype_shard(case["protos"], mesh.model_rank(),
                                              mesh.model_size())).requires_grad_(True)
    bank = torch.from_numpy(case["bank"])
    loss = swav_loss(z1, z2, protos, bank_features=bank, group=group, **cfg)
    loss.backward()
    scores = torch.cat([z1, bank]).detach() @ protos.detach().T
    codes = sinkhorn_codes(scores, cfg["sinkhorn_eps"], cfg["sinkhorn_iters"], group)
    return {"loss": loss.item(), "codes": codes, "dz1": z1.grad, "dz2": z2.grad,
            "dprotos": protos.grad}


def tp_swav_steps(case):
    """The port's SwAV steps on `tiny` from `case["init"]` ({"model", "bank"}
    state dicts, the whole table), each rank's model rank's rows of the
    table, each global batch of `case["batches"]` sliced by data rank.
    Returns, after each step, the loss metric, the model's state dict (the
    rank's shard) and the bank's. With `case["jitter"]`, model rank 1's
    tower gradients are scaled by 1 + 2^-20 before the reduction."""
    from ssv_tpu_torch.convert import prototype_shard
    from ssv_tpu_torch.parallel import batch_slice, mesh
    from ssv_tpu_torch.train.base import DataInfo
    from ssv_tpu_torch.train.registry import build_algorithm

    algo = build_algorithm("swav", case["cfg"], "tiny", DataInfo(*case["info"]), "cpu")
    state = algo.init_state(torch.Generator().manual_seed(0))
    if case.get("jitter") and mesh.model_rank() == 1:
        # a kernel that sums in another order on this rank: its tower
        # gradients differ from its row's in the last bits
        for p in state.model.tower.parameters():
            p.register_hook(lambda g: g * (1 + 2 ** -20))
    model = dict(case["init"]["model"])
    model["prototypes.table"] = torch.from_numpy(prototype_shard(
        model["prototypes.table"].numpy(), mesh.model_rank(), mesh.model_size()))
    state.model.load_state_dict(model)
    state.extra["bank"].load_state_dict(case["init"]["bank"])
    out = []
    for batch in case["batches"]:
        state, metrics = algo.train_step(
            state, {k: batch_slice(torch.from_numpy(v)) for k, v in batch.items()})
        out.append({"loss": metrics["loss"].item(),
                    "model": {k: v.clone() for k, v in state.model.state_dict().items()},
                    "bank": {k: v.clone() for k, v in state.extra["bank"].state_dict().items()}})
    return out


def tp_checkpoint_refusals():
    """The messages `save_state` and `restore_state` raise with."""
    from ssv_tpu_torch.train.checkpoint import restore_state, save_state

    out = []
    for call in (lambda: save_state("unused", None, None),
                 lambda: restore_state("unused", None, None)):
        try:
            call()
            out.append(None)
        except RuntimeError as err:
            out.append(str(err))
    return out


def rank_tp(rank, world, tmp, model_parallel, cases):
    """Each of `cases` ({"layout": None, "loss": case, "steps": case,
    "jittered": case, "bn": cases, "checkpoint": None}, any subset) on a
    (world / model_parallel, model_parallel) layout."""
    start_group(rank, world, tmp, model_parallel=model_parallel)
    run = {"layout": lambda _: tp_layout(), "loss": tp_loss, "steps": tp_swav_steps,
           "jittered": tp_swav_steps,
           "checkpoint": lambda _: tp_checkpoint_refusals(),
           "bn": lambda cs: [batchnorm_case(*(torch.from_numpy(a) for a in arrays), sync=True)
                             for arrays in cs]}
    return {name: run[name](case) for name, case in cases.items()}


class StopAtEpoch(Exception):
    pass


def cli_rank(argv):
    """One rank of `python -m ssv_tpu_torch.main` under torchrun: argv is
    <result prefix> <stop epoch or 0> <main's arguments>.
    With a stop epoch, the algorithm's `pre_epoch` raises at that epoch's
    start (so `train_safe` saves `latest`). Writes <prefix><rank>.json:
    the epochs' records, the best KNN accuracy, the probe's accuracy, and
    whether the run stopped."""
    import json

    from ssv_tpu_torch import main as cli
    from ssv_tpu_torch.train import trainer as trainer_mod

    prefix, stop, *args = argv
    build = trainer_mod.build_algorithm
    seen = {}

    def build_with_stop(*a, **kw):
        algo = build(*a, **kw)
        pre_epoch = algo.pre_epoch

        def stop_at(state, trainer, epoch):
            seen["trainer"] = trainer
            if epoch == int(stop):
                raise StopAtEpoch(epoch)
            return pre_epoch(state, trainer, epoch)
        algo.pre_epoch = stop_at
        return algo

    trainer_mod.build_algorithm = build_with_stop
    try:
        trainer, stopped = cli.main(args), False
    except StopAtEpoch:
        trainer, stopped = seen["trainer"], True
    probe = trainer.linear_eval_stats
    out = {"epoch_stats": trainer.epoch_stats, "best_metric": trainer.best_metric,
           "probe": probe and probe["accuracy"], "stopped": stopped,
           "rank": int(os.environ["RANK"]), "world": int(os.environ["WORLD_SIZE"])}
    with open(f"{prefix}{out['rank']}.json", "w") as f:
        json.dump(out, f)


def load_script(name: str):
    """scripts/<name>.py as a module (importing it runs nothing)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", os.path.join(repo, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class TmpRedirect:
    """Stands in for a script's `os` module and `open`, moving its fixed
    `/tmp/...` paths under `root`."""

    def __init__(self, root):
        self.root = str(root)

    def moved(self, p):
        return os.path.join(self.root, p[len("/tmp/"):]) if str(p).startswith("/tmp/") else p

    def makedirs(self, p, exist_ok=False):
        os.makedirs(self.moved(p), exist_ok=exist_ok)

    def chdir(self, p):
        os.chdir(self.moved(p))

    def open(self, p, *args, **kwargs):
        return open(self.moved(p), *args, **kwargs)

    def __getattr__(self, name):
        return getattr(os, name)


def redirect_tmp(monkeypatch, module, root) -> TmpRedirect:
    redirect = TmpRedirect(root)
    monkeypatch.setattr(module, "os", redirect)
    monkeypatch.setattr(module, "open", redirect.open, raising=False)
    return redirect


if __name__ == "__main__":
    import sys

    if sys.argv[1] == "cli":
        cli_rank(sys.argv[2:])
