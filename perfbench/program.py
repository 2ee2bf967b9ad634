"""The system under test, `ssv_tpu_torch`, as the harness drives it: the
only module of the benchmark that imports it.

It builds the port's `Trainer` from a configuration file of
`perfbench/configs/` on the benchmark's images, puts the benchmark's
weights into its towers, drives its epochs as `Trainer.train` does (the
algorithm's hooks, `Trainer.epoch_indices`, `Trainer.begin_epoch`,
`Trainer.step`, the epoch's metrics read on the host), and reads back what
the comparison judges: the steps' losses, the first gradient as the
optimizer holds it, and the parameters.
"""

from __future__ import annotations

import torch


def build(config_path: str, cfg: dict, data: dict, draw_seed: int, device,
          overrides: dict | None = None):
    """The port's Trainer of the configuration, writing nothing, on the
    images of `data` (`inputs.images`), its device draws seeded with
    `draw_seed`."""
    from ssv_tpu_torch.data.datasets import Dataset, SplitArrays
    from ssv_tpu_torch.train.trainer import Trainer

    def split(name):
        return SplitArrays(data[f"{name}_images"].cpu().numpy(),
                           data[f"{name}_labels"].cpu().numpy())

    dataset = Dataset("cifar10", split("train"), split("test"), num_classes=10)
    return Trainer({"config": config_path, "algo": cfg["algo"], "arch": cfg["arch"],
                    "task": "train", "output": "perfbench"}, overrides=overrides,
                   make_dirs=False, seed=draw_seed, device=device, dataset=dataset)


def _leaves(trainer) -> dict[str, torch.nn.Parameter]:
    """Every parameter of the state's towers by the benchmark's names:
    `model.<name>` for the trained tower, `<key>.<name>` for each of the
    algorithm's other towers (BYOL's `target`)."""
    state = trainer.state
    out = {f"model.{n}": p for n, p in state.model.named_parameters()}
    for key, module in state.extra.items():
        out.update({f"{key}.{n}": p for n, p in module.named_parameters()})
    return out


@torch.no_grad()
def load_weights(trainer, weights: dict, buffers=()) -> None:
    """The benchmark's weights into the program: every parameter of its
    towers (`_leaves`), and each name of `buffers` (`<key>.<buffer>`, the
    state buffer `<buffer>` of the module `state.extra[<key>]`, or of the
    trained tower for `model`) into that buffer."""
    state, leaves = trainer.state, _leaves(trainer)
    named = [n for n in weights if n not in set(buffers)]
    if set(leaves) != set(named):
        raise KeyError("the benchmark's weights and the program's parameters differ: "
                       f"{sorted(set(leaves) ^ set(named))[:6]}")
    targets = dict(leaves)
    for name in buffers:
        key, _, rest = name.partition(".")
        module = state.model if key == "model" else state.extra.get(key)
        found = dict(module.named_buffers()) if module is not None else {}
        if rest not in found:
            raise KeyError(f"{name}: the program has no such buffer")
        targets[name] = found[rest]
    for name, t in targets.items():
        if tuple(t.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: program {tuple(t.shape)}, benchmark "
                             f"{tuple(weights[name].shape)}")
        t.copy_(weights[name])


def params(trainer) -> dict[str, torch.Tensor]:
    """Every parameter, copied to the host."""
    return {n: p.detach().float().cpu().clone() for n, p in _leaves(trainer).items()}


def _decay(value) -> float:
    return float(value.detach().cpu()) if torch.is_tensor(value) else float(value)


def first_grad(trainer, weights: dict) -> dict[str, torch.Tensor]:
    """The first step's gradient of each trained parameter as the optimizer
    took it (after the recipe's clamp), worked out from the optimizer's
    state after that one step and the weights it started from, with the
    decay each parameter's group used in that step:

      * torch's SGD: the momentum buffer, which then holds the gradient
        plus wd x the weights (the group's `weight_decay`, or the decay of
        the scheduler's table at the first step where the schedule adds it
        to the gradients);
      * the port's `OptaxAdam`: the first moment over 1 - b1 = 0.1 (its
        first step makes the moment 0.1 g), less wd x the weights where the
        decay is coupled (the group's `decoupled` false; decoupled decay
        never reaches the moment).

    A parameter with no state got no gradient: zeros. Any other optimizer
    raises."""
    from ssv_tpu_torch.train.optim import OptaxAdam

    state = trainer.state
    opt = state.optimizer
    if isinstance(opt, OptaxAdam):
        def took(st, w, group):
            if "mu" not in st:
                return None
            g = st["mu"].double().cpu() / 0.1
            if not group["decoupled"]:
                g = g - _decay(group["weight_decay"]) * w.double()
            return g.float()
    elif isinstance(opt, torch.optim.SGD):
        sched = state.scheduler
        column = sched.columns.get("weight_decay")
        scheduled = 0.0 if column is None else _decay(sched.table[0, column])

        def took(st, w, group):
            buf = st.get("momentum_buffer")
            if buf is None:
                return None
            return buf.float().cpu() - (_decay(group["weight_decay"]) + scheduled) * w
    else:
        raise TypeError(f"first_grad reads torch.optim.SGD and OptaxAdam, not "
                        f"{type(opt).__module__}.{type(opt).__name__}")
    group_of = {id(p): g for g in opt.param_groups for p in g["params"]}
    out = {}
    for n, p in state.model.named_parameters():
        w = weights[f"model.{n}"].cpu()
        g = took(opt.state[p], w, group_of[id(p)])
        out[f"model.{n}"] = torch.zeros_like(w) if g is None else g
    return out


def begin_run(trainer) -> None:
    """What `Trainer.train` runs before its first epoch."""
    trainer.state = trainer.algorithm.pre_train(trainer.state, trainer)


def begin_epoch(trainer, epoch: int) -> None:
    """Epoch `epoch` (from 1) begun as `Trainer.train` begins it: the
    algorithm's hook, the trainer's own index matrix of the epoch, put
    where the step reads it."""
    trainer.state = trainer.algorithm.pre_epoch(trainer.state, trainer, epoch)
    trainer.begin_epoch(trainer.epoch_indices())


def end_epoch(trainer, epoch: int) -> dict[str, torch.Tensor]:
    """Epoch `epoch` ended as `Trainer.train` ends it: every metric of its
    steps read to the host, then the algorithm's hook."""
    metrics = {k: v.cpu() for k, v in trainer._metric_bufs.items()}
    trainer.state = trainer.algorithm.post_epoch(trainer.state, epoch)
    return metrics


def losses(trainer, first: int, end: int) -> torch.Tensor:
    """The losses of steps first..end-1 of the epoch, read to the host."""
    return trainer._metric_bufs["loss"][first:end].float().cpu()


def replays(trainer) -> int:
    return trainer.graph.replays if trainer.graph is not None else 0


def warm(trainer) -> bool:
    """Whether the next step runs as every later one will: in graph mode
    once the step is captured and replayed, in step mode always."""
    return trainer.epoch_mode != "graph" or replays(trainer) > 0
