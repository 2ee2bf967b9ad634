"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

Everything a cell is made of is found by name from `BENCHMARK.json`: its
configuration in `configs/<config>.json` (the recipe as the port runs it,
and its `algo` and `arch`), its traffic in `workloads/<traffic>.json`, the
reference of its algorithm in `reference/<algo>.py` (its weights, views,
loss, optimizer and state: `reference/__init__.py`'s hooks), its FLOP
count in `counts/<algo>.py`, each metric's reader in
`metrics/<metric>.py`, and the limits of its comparison in
`limits/<cell>.json`. A new cell, configuration, algorithm or metric is new
files and entries; no file here changes.

A run (`measure`):

  * set-up: the images, labels and weights made on the device from the
    seed; the port's `Trainer` built on them; the first epoch begun as
    `Trainer.train` begins one; the first `check_steps` steps run through
    `Trainer.step` (in graph mode the eager warm-up steps, then the capture
    and replays of the captured step, the path the window runs), the first
    step's gradient read back after it, and the steps' losses and the
    parameters after the last; then steps until the program runs as it
    will in the window. `setup_s` is the process's start to the end of
    that, after a synchronise;
  * the window: that epoch's remaining steps, then whole epochs, each
    begun and ended as `Trainer.train` does (the algorithm's hooks, the
    trainer's own index matrix, the epoch's metrics read on the host); a
    CUDA event after every step; it closes at the first epoch end past
    `--seconds`, after a synchronise.
    With `--trace 1` the epochs up to `profile_after_share` of the seconds
    run unprofiled (the rates), then one epoch whose first
    `profile_steps` steps are profiled (the device's ops), and the window
    closes at that epoch's end;
  * after the window: the peak memory read, the program freed, the plain
    reference run over the same checked steps from the same inputs (it
    draws the epoch's order and the views from the same seed itself), and
    the comparison judged against the cell's limits (`compare.py`).
"""

from __future__ import annotations

import gc
import importlib
import itertools
import json
import statistics
import sys
import time
from pathlib import Path

import torch

from . import compare, devtrace, inputs, peaks, program, reference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ssv_tpu")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (`ssv_tpu_torch` is not `ssv_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Cell:
    """A cell of `BENCHMARK.json` with everything it names, loaded."""

    def __init__(self, name: str, root: Path = ROOT, overrides: dict | None = None,
                 traffic: dict | None = None):
        self.bench = _json(root / "BENCHMARK.json")
        entries = {w["name"]: w for w in self.bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(entries)}")
        self.name, self.entry = name, entries[name]
        bench_dir = root / self.bench["paths"][0]
        self.config_path = str(bench_dir / "configs" / f"{self.entry['config']}.json")
        self.cfg = _json(Path(self.config_path))
        # `overrides` (the tests' smaller sizes) go to both sides
        self.overrides = overrides
        if overrides:
            self.cfg = _merge(self.cfg, overrides)
        self.traffic = {**_json(bench_dir / "workloads" / f"{self.entry['traffic']}.json"),
                        **(traffic or {})}
        limits = bench_dir / "limits" / f"{name}.json"
        self.limits = _json(limits) if limits.is_file() else None
        self.batch = int(self.cfg["data"]["batch_size"])
        self.steps_per_epoch = int(self.traffic["n_train"]) // self.batch
        self.hw = tuple(self.traffic["image"][:2])
        self.specs = reference.algorithm(self.cfg["algo"]).specs(self.cfg)
        self.buffers = inputs.buffers(self.specs)
        counts = importlib.import_module(f"{__package__}.counts.{self.cfg['algo']}")
        self.flops_per_image = counts.flops_per_image(self.cfg, self.hw, self.batch)

    def metrics(self, traced: bool) -> list[dict]:
        """The end-to-end metrics this cell reports (untraced), or its
        per-layer metrics (traced): those that list it, and those that list
        no cells and move an end-to-end metric it reports."""
        mine = [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]
        if not traced:
            return mine
        moved = {m["name"] for m in mine}
        return [m for m in self.bench["per_layer"]
                if self.name in m["workloads"]] + [
                m for m in self.bench["per_layer"]
                if "workloads" not in m and m["moves"] in moved]


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def read_metric(name: str, run: dict):
    """The reader `metrics/<name>.py`'s value for the run, or None where it
    found nothing to read."""
    return importlib.import_module(f"{__package__}.metrics.{name}").read(run)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _setup(cell: Cell, trainer, weights: dict, log, t_start: float) -> dict:
    """The first steps (module docstring); the program's readings."""
    k = int(cell.traffic["check_steps"])
    program.begin_run(trainer)
    program.begin_epoch(trainer, 1)
    prog, pos = {}, 0
    while pos < k or not program.warm(trainer):
        if pos >= cell.steps_per_epoch - 1:
            raise RuntimeError(f"set-up took {pos} steps: the epoch has {cell.steps_per_epoch}")
        trainer.step(trainer.state)
        pos += 1
        log(f"[perfbench] set-up {time.perf_counter() - t_start:.3f} s: step {pos} queued")
        if pos == 1:
            prog["first_grad"] = program.first_grad(trainer, weights)
        if pos == k:
            prog["params"] = program.params(trainer)
            prog["losses"] = program.losses(trainer, 0, k).tolist()
            prog["replayed"] = program.replays(trainer)
    prog["pos"] = pos
    log(f"[perfbench] set-up: {k} checked steps ({prog['replayed']} of them graph replays), "
        f"{pos} steps before the window, epoch mode {trainer.epoch_mode}")
    return prog


def _window(cell: Cell, trainer, pos: int, seconds: float, traced: bool, device) -> dict:
    """The measured window (module docstring). Returns its counts and
    times; with `traced`, the profiled part's device ops and host events."""
    spe, batch = cell.steps_per_epoch, cell.batch
    cuda = device.type == "cuda"
    graph, replays0 = trainer.graph, program.replays(trainer)
    events, out = [], {"steps": 0, "failed": 0, "epochs": 0, "unprofiled": None,
                       "profile": None, "epoch_steps": []}
    first, epoch = pos, 1

    def mark():
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

    def run_steps(n):
        for _ in range(n):
            with torch.profiler.record_function("perfbench.step"):
                trainer.step(trainer.state)
            mark()

    _sync(device)
    t0 = time.perf_counter()
    mark()
    while True:
        if pos == spe:
            epoch += 1
            with torch.profiler.record_function("perfbench.begin_epoch"):
                program.begin_epoch(trainer, epoch)
            pos = first = 0
        if traced and out["unprofiled"] is not None:
            from torch.profiler import ProfilerActivity, profile

            n = min(int(cell.traffic["profile_steps"]), spe)
            _sync(device)
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            with profile(activities=acts) as prof:
                tp = time.perf_counter()
                run_steps(n)
                _sync(device)
                tp = time.perf_counter() - tp
            ops, host = devtrace.from_profiler(prof)
            out["profile"] = {"steps": n, "wall_s": tp, "ops": ops, "host": host}
            pos = n
        run_steps(spe - pos)
        with torch.profiler.record_function("perfbench.end_epoch"):
            losses = program.end_epoch(trainer, epoch)["loss"][first:spe]
        out["steps"] += spe - first
        out["epoch_steps"].append(spe - first)
        out["failed"] += int((~torch.isfinite(losses)).sum())
        out["epochs"] += 1
        pos = spe
        elapsed = time.perf_counter() - t0
        if traced:
            if out["profile"] is not None:
                break
            if elapsed >= float(cell.traffic["profile_after_share"]) * seconds:
                out["unprofiled"] = {"images": out["steps"] * batch, "seconds": elapsed,
                                     "intervals": len(events) - 1}
        elif elapsed >= seconds:
            break
    _sync(device)
    out["seconds"] = time.perf_counter() - t0
    out["images"] = out["steps"] * batch
    out["replays"] = (program.replays(trainer) - replays0 if trainer.graph is graph
                      else program.replays(trainer))
    out["recaptured"] = trainer.graph is not graph
    out["step_ms"] = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    bounds = [0] + list(itertools.accumulate(out["epoch_steps"]))
    out["epoch_ms"] = [out["step_ms"][a:b] for a, b in zip(bounds, bounds[1:]) if b > a]
    out["epoch_mode"] = trainer.epoch_mode
    return out


def measure(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
            log=print, warn=None, detail: dict | None = None) -> dict:
    """One run (module docstring). Returns the result line's object, with
    the comparison's numbers and limits last, under `checks`; `detail`,
    where given, gets every number of the comparison with the leaf or step
    it comes from."""
    warn = warn or (lambda msg: print(msg, file=sys.stderr))
    device = torch.device(device)
    cuda = device.type == "cuda"
    seeds = inputs.streams(seed)
    log(f"[perfbench] set-up {time.perf_counter() - t_start:.3f} s: imports done")
    weights = inputs.weights(cell.specs, seed, device)
    data = inputs.images(cell.traffic, seed, device)
    _sync(device)
    log(f"[perfbench] set-up {time.perf_counter() - t_start:.3f} s: inputs made")
    trainer = program.build(cell.config_path, cell.cfg, data, seeds["draws"], device,
                            cell.overrides)
    del data
    program.load_weights(trainer, weights, cell.buffers)
    log(f"[perfbench] set-up {time.perf_counter() - t_start:.3f} s: trainer built")
    weights = {n: w.cpu() for n, w in weights.items()}
    prog = _setup(cell, trainer, weights, log, t_start)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"[perfbench] set-up {setup_s:.3f} s: steps done")

    win = _window(cell, trainer, prog["pos"], seconds, traced, device)
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    card = peaks.card_line() if cuda else "cpu"
    log(f"[perfbench] {cell.name} seed {seed}: window {win['seconds']:.3f} s, {win['steps']} "
        f"steps in {win['epochs']} epochs, {win['replays']} graph replays; peak "
        f"{peak / 2**30:.3f} GiB | {card}")
    if len(win["step_ms"]) >= 20:
        q = statistics.quantiles(win["step_ms"], n=20)
        log(f"[perfbench] step intervals (ms): p5 {q[0]:.4f}, median "
            f"{statistics.median(win['step_ms']):.4f}, p95 {q[18]:.4f}, max "
            f"{max(win['step_ms']):.4f}; their sum {sum(win['step_ms']) / 1e3:.4f} s")
        log("[perfbench] median step interval an epoch (ms): " + ", ".join(
            f"{statistics.median(e):.3f}" for e in win["epoch_ms"]))
    del trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference, from the same inputs made again
    images = inputs.images(cell.traffic, seed, device)["train_images"]
    start = inputs.weights(cell.specs, seed, device)
    ref = reference.run_steps(cell.cfg, start, images, len(prog["losses"]), seeds["draws"],
                              cell.steps_per_epoch)
    nums = compare.numbers(prog, ref, start)
    if detail is not None:
        detail.update(nums, details=compare.details(prog, ref, start))
    del images, start, ref
    if cell.limits is None:
        correct, checks = False, {k: {"value": nums[k][0], "limit": None}
                                  for k in compare.NUMBERS}
        warn(f"[perfbench] no limits for {cell.name}: correct is false")
    else:
        correct, checks = compare.judge(nums, cell.limits)

    run = {"cell": cell.name, "config": cell.cfg, "traffic": cell.traffic,
           "batch": cell.batch, "hw": cell.hw, "setup_s": setup_s, **win,
           "card": name, "card_line": card, "peaks": peaks.PEAKS.get(name),
           "flops_per_image": cell.flops_per_image}
    if traced:
        p, u = win["profile"], win["unprofiled"]
        log(f"[perfbench] traced run: rates from the unprofiled part ({u['images']} images in "
            f"{u['seconds']:.3f} s); device ops from the profiled part ({p['steps']} steps, "
            f"{p['wall_s']:.4f} s, {len(p['ops'])} device ops)")
    metrics = {}
    for m in cell.metrics(traced):
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": win["steps"],
              "failed": win["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": name, "count": 1,
                         "memory_peak_bytes": peak}}
    if traced:
        ops = win["profile"]["ops"]
        result["device"]["busy_s"] = devtrace.busy_us((a, b) for _, a, b in ops) / 1e6
        result["device"]["window_s"] = devtrace.span_us(ops) / 1e6
        result["breakdown"] = {"device_ops": devtrace.top_ops(ops),
                               "idle_gaps": devtrace.longest_gaps(ops, win["profile"]["host"])}
    for k in compare.NUMBERS:
        if k not in checks:
            warn(f"[perfbench] not compared: {k} {nums[k][0]!r} (worst at {nums[k][1]}); "
                 f"the cell's limits name no limit for it")
    warn(f"[perfbench] compared steps 1-{len(prog['losses'])}, "
         f"{prog['replayed']} of them graph replays")
    for k, c in checks.items():
        warn(f"check {k} {c['value']!r} limit {c['limit']!r} (worst at {nums[k][1]})")
    result["checks"] = checks
    return result


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on one card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[perfbench] {args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"[perfbench] loaded in this process: {bad}; no result", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

