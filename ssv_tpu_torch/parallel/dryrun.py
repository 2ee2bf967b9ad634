"""A dry run of data-parallel and data x model-parallel training at a tiny
size (counterpart of `__graft_entry__.dryrun_multichip`'s four phases):

    torchrun --nproc_per_node N -m ssv_tpu_torch.parallel.dryrun [--device cpu]

on the CPU over gloo, or on the cards over NCCL (one rank a card). Every
phase checks that the state is the same, bit for bit, on every rank.

1. sync SimCLR: one step of the `tiny` encoder on a global batch of 4N,
   every BatchNorm taking global statistics;
2. DPxTP SwAV, at an even world: the ranks laid out as (N / 2, 2) over
   (data, model), SwAV's 128-row prototype table sharded by rows over the
   model group, the scores column-parallel and Sinkhorn's reductions
   across the model group: a float32 step on given views, held against a
   one-process step of the same state on the same global batch (the
   gathered table, the tower, the loss), then a step on each data rank's
   own draws; the tower the same on every rank, each shard the same across
   its data group, the bank the same everywhere;
3. MoCo: an 8-step epoch (the queue pointer at 8 global batches), a
   checkpoint saved and restored by every rank (step, pointer and queue
   checked), one more step on the restored state, then one
   `per_device_bn` step of a MoCo loaded from it (the queue advanced by
   the global batch);
4. DINO: a multi-crop epoch through the `Trainer` (a synthetic dataset, the
   per-step teacher EMA), KNN and the linear probe through its gathered
   `features_for` (the same accuracy on every rank), and one
   `per_device_bn` PIRL step whose bank update covers the global batch.
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import os
import shutil
import tempfile

import torch
import yaml

from . import mesh
from .mesh import batch_slice, gather_objects, rank, world_size

TP_TOL = 1e-5   # the DPxTP step against one process's: params, abs (float32)

NORM = {"mean": [0.4914, 0.4822, 0.4465], "std": [0.2470, 0.2435, 0.2616]}
TRANSFORMS = {
    "train": {"color_jitter": {"brightness": 0.4, "contrast": 0.4, "saturation": 0.4,
                               "hue": 0.1, "apply_prob": 0.8},
              "random_gray": {"p": 0.2},
              "random_resized_crop": {"size": [32, 32], "scale": [0.2, 1.0]},
              "random_flip": None, "to_tensor": None, "normalize": NORM},
    "test": {"center_crop": {"size": [32, 32]}, "to_tensor": None, "normalize": NORM},
}
SGD = {"name": "sgd", "lr": 0.1, "momentum": 0.9, "nesterov": True, "weight_decay": 1e-6}


def _config(batch: int, **extra) -> dict:
    cfg = {"epochs": 1, "eval_every": 1, "encoder": {"features": 32},
           "optimizer": dict(SGD), "scheduler": {"name": "cosine", "warmup_epochs": 0},
           "linear_eval": {"epochs": 2, "batch_size": batch, "lr": 0.1},
           "wandb": {"project": None},
           "data": {"dataset_name": "cifar10", "root": "", "batch_size": batch,
                    "transforms": copy.deepcopy(TRANSFORMS)}}
    cfg.update(extra)
    return cfg


def digest(*modules) -> str:
    """A hash of the modules' parameters and buffers, bit for bit."""
    h = hashlib.sha256()
    for m in modules:
        for t in (*m.parameters(), *m.buffers()):
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _check_replicated(phase: str, *modules) -> None:
    digests = gather_objects(digest(*modules))
    if len(set(digests)) != 1:
        raise AssertionError(f"{phase}: the ranks' states differ: {digests}")


def _say(msg: str) -> None:
    if rank() == 0:
        print(msg, flush=True)


def _check_finite(phase: str, loss) -> float:
    value = float(loss)
    if value != value or abs(value) == float("inf"):
        raise AssertionError(f"{phase}: non-finite loss {value}")
    return value


def _algorithm(name: str, cfg: dict, batch: int, steps: int, device):
    from ..data.pipeline import DataPipeline
    from ..train.base import DataInfo
    from ..train.registry import build_algorithm

    pipeline = DataPipeline(cfg["data"], device, synthetic_sizes=(batch * steps, batch))
    info = DataInfo(10, pipeline.n_train, batch, steps)
    return build_algorithm(name, cfg, "tiny", info, device), pipeline


def phase_sync_simclr(device, generator) -> None:
    from ..models.resnet import _FlaxRunningVar

    batch = 4 * world_size()
    cfg = _config(batch, proj_dim=16, loss_fn={"normalize": True, "temperature": 0.5})
    algo, pipeline = _algorithm("simclr", cfg, batch, 2, device)
    state = algo.init_state(torch.Generator().manual_seed(0))
    bns = [m for m in state.model.modules() if isinstance(m, _FlaxRunningVar)]
    if world_size() > 1 and not all(m.sync for m in bns):
        raise AssertionError("sync SimCLR: a BatchNorm does not take global statistics")
    images, labels = pipeline.arrays("train")
    idx = batch_slice(torch.arange(batch, device=device))
    state, metrics = algo.train_step(
        state, pipeline.make_batch_fn("double")(images, labels, idx, generator), generator)
    loss = _check_finite("sync SimCLR", metrics["loss"])
    _check_replicated("sync SimCLR", state.model)
    _say(f"[dryrun] sync SimCLR: {world_size()} ranks, global batch {batch}, "
          f"{len(bns)} BatchNorms over the global batch, loss {loss:.4f}")


def _max_diff(a: dict, b: dict) -> float:
    return max((a[k].float() - b[k].float()).abs().max().item() for k in b
               if b[k].is_floating_point())


def phase_dp_tp_swav(device) -> None:
    """The JAX dry run's phase 2 (`__graft_entry__.py:172-219`) at its
    shapes: `tiny` (features 32), hidden 32, proj 16, 128 prototypes, a bank
    of 32, 3 Sinkhorn iterations, SGD at 0.1, a global batch of 4N, on an
    (N / 2, 2) layout; float32."""
    from ..data.pipeline import DataPipeline
    from ..objectives.losses import l2_normalize
    from ..state.banks import ring_push
    from ..train.base import DataInfo
    from ..train.registry import build_algorithm

    w = world_size()
    if w % 2:
        _say(f"[dryrun] DPxTP SwAV: skipped, a model axis of 2 needs an even world, not {w}")
        return
    batch = 4 * w
    cfg = _config(batch, hidden_dim=32, proj_dim=16, prototype_size=128,
                  feature_bank_size=32, compute_dtype="float32",
                  optimizer={"name": "sgd", "lr": 0.1, "weight_decay": 1e-6},
                  loss_fn={"temperature": 0.1, "sinkhorn_eps": 0.05, "sinkhorn_iters": 3})
    pipeline = DataPipeline(cfg["data"], device, synthetic_sizes=(2 * batch, batch))
    info = DataInfo(10, pipeline.n_train, batch, 2)
    images, labels = pipeline.arrays("train")
    batch_fn = pipeline.make_batch_fn("double")
    idx = torch.arange(batch, device=device)
    # the global batch's views, the same on every rank; the bank's rows
    views = batch_fn(images, labels, idx, torch.Generator(device=device).manual_seed(0))
    rows = l2_normalize(torch.randn(32, 16, generator=torch.Generator().manual_seed(1)))
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def start():
        algo = build_algorithm("swav", cfg, "tiny", info, device)
        state = algo.init_state(torch.Generator().manual_seed(0))
        ring_push(state.extra["bank"], rows.to(device))
        return algo, state

    try:
        with mesh.local():
            algo, state = start()
            state, metrics = algo.train_step(state, views)
            ref_loss = float(metrics["loss"])
            ref = {k: v.cpu() for k, v in state.model.state_dict().items()}
        mesh.set_model_parallel(2)
        algo, state = start()
        state, metrics = algo.train_step(
            state, {k: batch_slice(v) for k, v in views.items()})
        loss = _check_finite("DPxTP SwAV", metrics["loss"])
        got = {k: v.cpu() for k, v in state.model.state_dict().items()}
        shards = gather_objects((mesh.model_rank(), got.pop("prototypes.table")))
        got["prototypes.table"] = torch.cat([t for _, t in shards[:2]])
        table_err = _max_diff(got, {"prototypes.table": ref["prototypes.table"]})
        tower_err = _max_diff(got, {k: v for k, v in ref.items() if k.startswith("tower.")})
        loss_err = abs(loss - ref_loss) / abs(ref_loss)
        if table_err > TP_TOL or tower_err > TP_TOL or loss_err > TP_TOL:
            raise AssertionError(f"DPxTP SwAV: the step differs from one process's: table "
                                 f"{table_err:.3e}, tower {tower_err:.3e}, loss {loss_err:.3e}")

        # a step on each data rank's own draws: the model ranks of a row
        # draw the same rows
        generator = torch.Generator(device=device).manual_seed(mesh.data_rank())
        state, metrics = algo.train_step(
            state, batch_fn(images, labels, batch_slice(idx + batch), generator))
        _check_finite("DPxTP SwAV", metrics["loss"])
        _check_replicated("DPxTP SwAV", state.model.tower, state.extra["bank"])
        by_shard: dict[int, set] = {}
        for m, d in gather_objects((mesh.model_rank(), digest(state.model.prototypes))):
            by_shard.setdefault(m, set()).add(d)
        if sorted(by_shard) != [0, 1] or any(len(d) != 1 for d in by_shard.values()):
            raise AssertionError(f"DPxTP SwAV: a shard differs across its data group: "
                                 f"{by_shard}")
    finally:
        mesh.set_model_parallel(1)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    _say(f"[dryrun] DPxTP SwAV: {w // 2} x 2 ranks (data x model), 128 prototypes, 64 a "
         f"rank, global batch {batch}, loss {loss:.4f}; against one process's float32 "
         f"step: the gathered table within {table_err:.3e}, the tower {tower_err:.3e}, the "
         f"loss {loss_err:.3e} relative; a second step on each data rank's draws: the tower "
         f"the same on every rank, each shard across its data group")


def phase_moco(device, generator, tmp: str) -> None:
    from ..train.checkpoint import restore_state, save_state

    batch, steps, queue = 4 * world_size(), 8, 48
    cfg = _config(batch, proj_dim=16, queue_size=queue, momentum=0.99,
                  loss_fn={"normalize": True, "temperature": 0.07})
    algo, pipeline = _algorithm("moco", cfg, batch, steps, device)
    state = algo.init_state(torch.Generator().manual_seed(3))
    images, labels = pipeline.arrays("train")
    batch_fn = pipeline.make_batch_fn("double")
    idx_mat = torch.arange(batch * steps, device=device).reshape(steps, batch)

    def step(algo, state, idx):
        state, metrics = algo.train_step(
            state, batch_fn(images, labels, batch_slice(idx), generator), generator)
        _check_finite("MoCo", metrics["loss"])
        return state

    for s in range(steps):
        state = step(algo, state, idx_mat[s])
    want_ptr = steps * batch % queue
    if int(state.extra["queue"].ptr) != want_ptr:
        raise AssertionError(f"MoCo: queue pointer {int(state.extra['queue'].ptr)}, "
                             f"expected {want_ptr}")

    path = os.path.join(tmp, "moco")
    save_state(path, state, generator)
    mesh.barrier()
    # a template from another algorithm object: init_state places the
    # algorithm's own modules, so a second call would return the same ones
    restored = _algorithm("moco", cfg, batch, steps, device)[0].init_state(
        torch.Generator().manual_seed(5))
    restore_state(path, restored, generator)
    if (restored.step != steps or int(restored.extra["queue"].ptr) != want_ptr
            or not torch.equal(restored.extra["queue"].data, state.extra["queue"].data)):
        raise AssertionError("MoCo: the restored state differs from the saved one")
    restored = step(algo, restored, idx_mat[0])
    if int(restored.extra["queue"].ptr) != (want_ptr + batch) % queue:
        raise AssertionError("MoCo: the step on the restored state missed the queue")

    pd_algo, _ = _algorithm("moco", dict(cfg, per_device_bn=True), batch, steps, device)
    pd_state = pd_algo.init_state(torch.Generator().manual_seed(5))
    pd_state.model.load_state_dict(restored.model.state_dict())
    for k, m in pd_state.extra.items():
        m.load_state_dict(restored.extra[k].state_dict())
    pd_state = step(pd_algo, pd_state, idx_mat[1])
    if int(pd_state.extra["queue"].ptr) != (want_ptr + 2 * batch) % queue:
        raise AssertionError("MoCo per_device_bn: the queue did not take the global batch")
    _check_replicated("MoCo", pd_state.model, *pd_state.extra.values())
    _say(f"[dryrun] MoCo: {steps}-step epoch, queue pointer {want_ptr}, checkpoint "
          f"round trip, a step on the restored state, a per_device_bn step")


def phase_dino_pirl(device, generator, tmp: str) -> None:
    from ..state.banks import SampleBank
    from ..train.trainer import Trainer

    w = world_size()
    batch = 4 * w
    multicrop = {"num_global_views": 2, "num_local_views": 2, "scale_threshold": 0.3,
                 "global_size": [32, 32], "local_size": [16, 16],
                 "train_transforms": TRANSFORMS["train"],
                 "test_transforms": TRANSFORMS["test"]}
    cfg = _config(batch, proj_head={"hidden_dim": 64, "proj_dim": 32}, gradient_clip=3.0,
                  teacher_update="step", center_init="zeros",
                  optimizer={"name": "adamw", "lr": 1e-3, "weight_decay": 0.04})
    cfg["data"] = {"dataset_name": "cifar10", "root": "", "batch_size": batch,
                   "multicrop_config": multicrop}
    cfg_path = os.path.join(tmp, "dino.yaml")
    if rank() == 0:
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f, sort_keys=False)
    mesh.barrier()
    trainer = Trainer({"config": cfg_path, "algo": "dino", "arch": "tiny", "task": "train",
                       "output": os.path.join(tmp, "dino"), "load": None},
                      device=device, synthetic_sizes=(2 * batch, 32))
    state, metrics, _ = trainer._run_epoch(trainer.state, trainer.epoch_indices())
    trainer.state = trainer.algorithm.post_epoch(state, 1)
    for loss in metrics["loss"]:
        _check_finite("DINO", loss)
    knn, probe = trainer.knn_validate(), trainer.perform_linear_eval()
    accs = gather_objects((knn, probe))
    if len(set(accs)) != 1 or not all(0.0 <= a <= 1.0 for a in accs[0]):
        raise AssertionError(f"DINO: KNN and probe accuracies by rank {accs}")
    _check_replicated("DINO", trainer.state.model, *trainer.state.extra.values())

    pcfg = _config(batch, proj_dim=16, num_patches=4, patch_size=16, momentum=0.5,
                   num_negatives=4, per_device_bn=True,
                   loss_fn={"normalize": True, "temperature": 0.07})
    pirl, pipeline = _algorithm("pirl", pcfg, batch, 2, device)
    pstate = pirl.init_state(torch.Generator().manual_seed(10))
    images, labels = pipeline.arrays("train")
    idx = torch.arange(batch, device=device)
    pstate, pmetrics = pirl.train_step(
        pstate, pipeline.make_batch_fn("double")(images, labels, batch_slice(idx), generator),
        generator)
    _check_finite("PIRL", pmetrics["loss"])
    bank: SampleBank = pstate.extra["bank"]
    if not (bank.data[idx].norm(dim=1) > 1e-6).all():
        raise AssertionError("PIRL per_device_bn: the bank update missed rows of the "
                             "global batch")
    _check_replicated("PIRL", pstate.model, bank)
    _say(f"[dryrun] DINO: a {metrics['loss'].numel()}-step multi-crop epoch through the "
          f"Trainer, KNN {knn:.4f} and probe {probe:.4f} on every rank; PIRL "
          f"per_device_bn step over the global batch's {batch} bank rows")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m ssv_tpu_torch.parallel.dryrun")
    ap.add_argument("-d", "--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if not mesh.launched():
        raise RuntimeError("run the dry run under torchrun: torchrun --nproc_per_node N "
                           "-m ssv_tpu_torch.parallel.dryrun")
    device = mesh.init_from_env(args.device)
    me, world = rank(), world_size()
    tmp = mesh.broadcast_object(tempfile.mkdtemp(prefix="ssv_dryrun_") if me == 0 else None)
    try:
        generator = torch.Generator(device=device).manual_seed(me)
        phase_sync_simclr(device, generator)
        phase_dp_tp_swav(device)
        phase_moco(device, generator, tmp)
        phase_dino_pirl(device, generator, tmp)
        mesh.barrier()
        _say(f"[dryrun] every phase passed at {world} ranks on {device.type}")
    finally:
        if me == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        mesh.destroy()


if __name__ == "__main__":
    main()
