"""Where a traced epoch's device time goes, read from a Chrome trace: the
counterpart of the JAX system's `scripts/profile_report.py`.

    python -m ssv_tpu_torch.tools.profile_report <trace.json | dir>
    python -m ssv_tpu_torch.tools.profile_report --capture [batch]

The first form reads a trace the trainer's profile hook wrote
(`SSV_TPU_PROFILE_DIR=<dir>` on any training run: `<dir>/epoch<e>.rank<r>.json`,
`Trainer._trace`); given a directory it reads the last such file in it.
`--capture` first traces the bench's timed epoch (`ssv_tpu_torch.bench`:
SimCLR ResNet-18, 100 steps at `batch`, default 512, in graph mode, after
its warm epoch) through the same hook into `outputs/profile_report/`, on
the card, then reads it.

It reports the device timeline's wall time (first device op's start to
the last one's end), the duty (the union of the device ops' intervals over
that wall), busy time and ops by kind, and the kernels that take the most
of it. The device ops, their union and their kinds are `tools/step_profile.py`'s
(`device_ops`, `busy_us`, `kind_of`), so the two tools classify alike.

What JAX's report leaves out and what that is here: it drops XLA's async
copy starts and dones, whose spans overlap the compute, and the `while`
op that wraps the scanned epoch. The port's epoch has no wrapper op (each
step is a graph replay of its kernels), and its copies and sets are device
work of their own, so they stay; what is dropped is what the profiler
mirrors on the device's timeline around the kernels (user annotations,
`Optimizer.step#...`). A trace with no device op raises.
"""

from __future__ import annotations

import glob
import json
import os
import sys
from typing import NamedTuple

import torch

from .step_profile import busy_us, device_ops, kind_of

# the trace's categories of events on the card: kernels, copies and sets,
# and the annotations the profiler mirrors there
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")
TOP = 15


class _Range(NamedTuple):
    start: float
    end: float


class TraceOp(NamedTuple):
    """One complete event of a Chrome trace, with the attributes
    `step_profile.device_ops` reads of a profiler event."""
    name: str
    device_type: object
    is_user_annotation: bool
    time_range: _Range


def find_trace(path: str) -> str:
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(os.path.join(path, "epoch*.rank*.json")))
    if not hits:
        raise FileNotFoundError(f"no epoch<e>.rank<r>.json trace under {path}")
    return hits[-1]


def trace_ops(path: str) -> list[TraceOp]:
    """The trace's complete events as `TraceOp`s, times in µs."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    return [TraceOp(e["name"], cuda if e.get("cat") in DEVICE_CATEGORIES else cpu,
                    e.get("cat") in ("user_annotation", "gpu_user_annotation"),
                    _Range(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))))
            for e in events if e.get("ph") == "X"]


def report(path: str, top: int = TOP) -> dict:
    """Reads the trace at `path` (a file or a directory), prints the report
    and returns it: wall and busy ms, the duty, ms and ops by kind, ms of the
    top kernels, the device ops counted."""
    path = find_trace(path)
    ops = device_ops(trace_ops(path))
    if not ops:
        raise RuntimeError(f"{path}: no device op in the trace (was it captured on a "
                           f"CUDA card, with the CUDA activity?)")
    spans = [(op.time_range.start, op.time_range.end) for op in ops]
    t0, t1 = min(a for a, _ in spans), max(b for _, b in spans)
    wall_ms, busy_ms = (t1 - t0) / 1e3, busy_us(spans) / 1e3
    by_name: dict[str, float] = {}
    for op in ops:
        by_name[op.name] = by_name.get(op.name, 0.0) + (op.time_range.end
                                                        - op.time_range.start) / 1e3
    by_kind: dict[str, float] = {}
    for name, ms in by_name.items():
        by_kind[kind_of(name)] = by_kind.get(kind_of(name), 0.0) + ms
    ops_by_kind: dict[str, int] = {}
    for op in ops:
        ops_by_kind[kind_of(op.name)] = ops_by_kind.get(kind_of(op.name), 0) + 1
    out = {"trace": path, "device_ops": len(ops), "wall_ms": wall_ms, "busy_ms": busy_ms,
           "duty": busy_ms / wall_ms if wall_ms else 1.0,
           "ms_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
           "ops_by_kind": ops_by_kind,
           "top_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top])}
    summed = sum(by_kind.values())
    print(f"trace {path}: {len(ops):,} device ops")
    print(f"device timeline wall {wall_ms:,.3f} ms | busy (the union of the device ops) "
          f"{busy_ms:,.3f} ms ({out['duty']:.1%} duty)")
    for kind, ms in out["ms_by_kind"].items():
        print(f"  {kind:24s} {ms:10.3f} ms  {ms / summed:6.1%} of device time  "
              f"{ms / wall_ms if wall_ms else 1.0:6.1%} of wall  {ops_by_kind[kind]:,} ops")
    for name, ms in out["top_ms"].items():
        print(f"  {ms:10.3f} ms  {name[:110]}")
    return out


def capture(batch: int = 512, out_dir: str = os.path.join("outputs", "profile_report")) -> str:
    """Traces the bench's timed epoch at `batch` (after its warm epoch, in
    graph mode) with the trainer's profile hook; returns the trace's path."""
    from ..bench import build_trainer, epoch_permutation, index_matrix
    from ..train.graph import WARMUP_STEPS

    if not torch.cuda.is_available():
        raise RuntimeError("--capture traces a CUDA card; none found")
    steps, n_train = 100, max(8192, 4 * batch)
    trainer = build_trainer(batch, n_train, "cuda")
    state = trainer.state
    state.scheduler.reserve(2 * steps)
    trainer._run_epoch(state, index_matrix(epoch_permutation(0, n_train), steps, batch).cuda())
    with trainer._trace(out_dir, 2):
        trainer._run_epoch(state,
                           index_matrix(epoch_permutation(1, n_train), steps, batch).cuda())
    graph = trainer.graph
    if graph is None or graph.replays != 2 * steps - WARMUP_STEPS:
        raise RuntimeError("the traced epoch was not all replays of one graph")
    return os.path.join(out_dir, "epoch2.rank0.json")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    if "--capture" in argv:
        path = capture(int(args[0]) if args else 512)
    elif args:
        path = args[0]
    else:
        print(__doc__)
        sys.exit(2)
    print(json.dumps(report(path)))


if __name__ == "__main__":
    main()
