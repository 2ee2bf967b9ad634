"""Finds what keeps a dropped `Trainer`'s device memory allocated.

    python -m ssv_tpu_torch.tools.holders [--out outputs/holders.json]

Builds SimCLR ResNet-18 trainers on a small staged CIFAR-10 on the CUDA card
and drops each one after a different amount of work: built only, two train
steps, a whole `train()` through the CLI (KNN, checkpoints, the probe). For
each it reports the bytes still allocated after `gc.collect()`, whether weak
references to the trainer, its model and its dataset tensor are dead, and,
where the dataset tensor lives on, the chain of objects that refer to it
(`gc.get_referrers`), and the largest CUDA tensors Python still reaches.
With `torch.cuda.memory._record_memory_history` on, the blocks still
allocated that the case allocated are grouped by the Python stack that
allocated them (`torch.cuda.memory._snapshot`). Needs a card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import types
import weakref

import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _stage(root: str, n_train: int = 2048, n_test: int = 512) -> None:
    """A small CIFAR-10 in the pickle layout under root/cifar-10-batches-py."""
    import pickle

    import numpy as np

    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(1, 6):
        with open(os.path.join(d, f"data_batch_{i}"), "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (n_train // 5, 3072), dtype=np.uint8),
                         "labels": rng.randint(0, 10, n_train // 5).tolist()}, f)
    with open(os.path.join(d, "test_batch"), "wb") as f:
        pickle.dump({"data": rng.randint(0, 256, (n_test, 3072), dtype=np.uint8),
                     "labels": rng.randint(0, 10, n_test).tolist()}, f)


def _describe(obj, child) -> str:
    if isinstance(obj, types.FrameType):
        return f"frame {obj.f_code.co_name} {obj.f_code.co_filename}:{obj.f_lineno}"
    if isinstance(obj, dict):
        return f"dict of {len(obj)}, at keys {[k for k, v in obj.items() if v is child][:4]}"
    if isinstance(obj, (list, tuple)):
        return f"{type(obj).__name__} of {len(obj)}"
    if isinstance(obj, types.CellType):
        return "cell"
    if isinstance(obj, types.FunctionType):
        return f"function {obj.__qualname__} ({obj.__code__.co_filename})"
    return f"{type(obj).__module__}.{type(obj).__qualname__}"


def referrer_chains(target, depth: int = 7, fan: int = 3) -> list[str]:
    """The objects that refer to `target`, and those that refer to them, up
    to `depth` levels and `fan` referrers a level, as indented lines. This
    module's own frames and containers are left out."""
    own = {id(sys._getframe())}
    lines: list[str] = []
    seen: set[int] = set()

    def walk(obj, level, path_ids):
        if level >= depth:
            return
        # indexed loops: an iterator or a slice would be a referrer of its own
        refs = gc.get_referrers(obj)
        picked = []
        own.update((id(refs), id(picked)))
        i = 0
        while i < len(refs) and len(picked) < fan:
            r = refs[i]
            i += 1
            if id(r) in own or id(r) in path_ids or (
                    isinstance(r, types.FrameType) and r.f_code.co_filename == __file__):
                continue
            picked.append(r)
        j = 0
        while j < len(picked):
            r = picked[j]
            j += 1
            lines.append("  " * level + _describe(r, obj))
            if id(r) in seen:
                lines.append("  " * (level + 1) + "(seen)")
                continue
            seen.add(id(r))
            if isinstance(r, types.ModuleType):
                continue
            walk(r, level + 1, path_ids | {id(r)})

    walk(target, 0, {id(target)})
    return lines


def largest_cuda_tensors(n: int = 5) -> list:
    """The `n` largest CUDA tensors that Python objects reach, as (bytes,
    tensor), largest first."""
    found = [(o.untyped_storage().nbytes(), o) for o in gc.get_objects()
             if isinstance(o, torch.Tensor) and o.is_cuda]
    found.sort(key=lambda bt: -bt[0])
    return found[:n]


def _live_blocks() -> dict[int, dict]:
    out = {}
    for seg in torch.cuda.memory._snapshot()["segments"]:
        addr = seg["address"]
        for block in seg["blocks"]:
            if block["state"] == "active_allocated":
                out[addr] = block
            addr += block["size"]
    return out


def _stack_key(block) -> str:
    frames = [f for f in block.get("frames", [])
              if f.get("filename", "").endswith(".py") and "torch/" not in f["filename"]]
    return " <- ".join(f"{os.path.relpath(f['filename'], HERE)}:{f['line']} {f['name']}"
                       for f in frames[:4]) or "(no Python frame)"


def run_case(name: str, cfg_path: str, tmp: str) -> dict:
    from ssv_tpu_torch import main as cli
    from ssv_tpu_torch.train.trainer import Trainer

    gc.collect()
    before_blocks = set(_live_blocks())
    before = torch.cuda.memory_allocated()
    out_dir = os.path.join(tmp, name)
    if name == "cli_train":
        trainer = cli.main(["-c", cfg_path, "-m", "resnet18", "-a", "simclr",
                            "-t", "train", "-o", out_dir])
    else:
        trainer = Trainer({"config": cfg_path, "algo": "simclr", "arch": "resnet18",
                           "task": "train", "output": out_dir})
        if name == "two_steps":
            idx = trainer.pipeline.epoch_indices(trainer.generator)[:2]
            trainer.state, _, _ = trainer._run_epoch(trainer.state, idx)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    refs = {"trainer": weakref.ref(trainer), "model": weakref.ref(trainer.state.model),
            "dataset": weakref.ref(trainer.pipeline._train_images)}
    del trainer
    gc.collect()
    left = torch.cuda.memory_allocated() - before
    alive = {k: r() is not None for k, r in refs.items()}
    chains = referrer_chains(refs["dataset"]()) if alive["dataset"] else []
    big = largest_cuda_tensors()
    groups: dict[str, list[int]] = {}
    for addr, block in _live_blocks().items():
        if addr not in before_blocks:
            g = groups.setdefault(_stack_key(block), [0, 0])
            g[0] += 1
            g[1] += block["size"]
    top = sorted(groups.items(), key=lambda kv: -kv[1][1])[:12]
    result = {"case": name, "bytes_while_alive": held, "bytes_left_after_drop": left,
              "largest_cuda_tensors": [[b, tuple(t.shape), str(t.dtype)] for b, t in big],
              "alive": alive,
              "referrers_of_dataset": chains,
              "left_blocks_by_stack": [{"stack": k, "blocks": n, "bytes": b}
                                       for k, (n, b) in top]}
    print(f"[holders] {name}: {held / 2**20:.1f} MiB while alive, "
          f"{left / 2**20:.1f} MiB left after the drop; alive {alive}")
    del big
    for line in chains[:40]:
        print(f"[holders]   {line}")
    for g in result["left_blocks_by_stack"][:6]:
        print(f"[holders]   {g['bytes'] / 2**20:8.2f} MiB in {g['blocks']} blocks: {g['stack']}")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m ssv_tpu_torch.tools.holders")
    ap.add_argument("--out", default=os.path.join("outputs", "holders.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the holders tool runs only on a GPU")
    import yaml

    torch.cuda.memory._record_memory_history(max_entries=200_000)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        _stage(os.path.join(tmp, "data"))
        with open(os.path.join(HERE, "configs", "simclr.yaml")) as f:
            cfg = yaml.safe_load(f)
        cfg.update(epochs=1, eval_every=1)
        cfg["data"].update(root=os.path.join(tmp, "data"), batch_size=256)
        cfg["linear_eval"].update(epochs=2)
        cfg_path = os.path.join(tmp, "simclr.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f, sort_keys=False)
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            for name in ("built", "two_steps", "cli_train", "built"):
                results.append(run_case(name, cfg_path, tmp))
        finally:
            os.chdir(cwd)
    torch.cuda.memory._record_memory_history(enabled=None)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": torch.cuda.get_device_name(0), "cases": results}, f, indent=1)


if __name__ == "__main__":
    main()
