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
def load_weights(trainer, weights: dict) -> None:
    leaves = _leaves(trainer)
    if set(leaves) != set(weights):
        raise KeyError("the benchmark's weights and the program's parameters differ: "
                       f"{sorted(set(leaves) ^ set(weights))[:6]}")
    for name, p in leaves.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: program {tuple(p.shape)}, benchmark "
                             f"{tuple(weights[name].shape)}")
        p.copy_(weights[name])


def params(trainer) -> dict[str, torch.Tensor]:
    """Every parameter, copied to the host."""
    return {n: p.detach().float().cpu().clone() for n, p in _leaves(trainer).items()}


def first_grad(trainer, weights: dict, weight_decay: float) -> dict[str, torch.Tensor]:
    """The first step's gradient of each trained parameter as the optimizer
    got it, worked out from its state after that one step: SGD's momentum
    buffer then holds the gradient plus weight_decay x the starting
    weights. A parameter without a buffer got no gradient: zeros."""
    state = trainer.state
    out = {}
    for n, p in state.model.named_parameters():
        buf = state.optimizer.state[p].get("momentum_buffer")
        w = weights[f"model.{n}"].cpu()
        out[f"model.{n}"] = (torch.zeros_like(w) if buf is None
                             else buf.float().cpu() - weight_decay * w)
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
