"""The readings a cell's limits are set from, on the card at the cell's own
size, in one process:

    python -m perfbench.calibrate --workload <cell> --seeds 1,2,... --control-seeds 1,2,3 \
        [--out chiprun_out/calibrate_<cell>.json]

For each of `--seeds`, a sound run of the program (`harness.measure` with
a window of one epoch's rest) and its three numbers against the
reference. For each of `--control-seeds`, the control and the faults, each
put in the program's place and judged against the float32 reference the
same way: the reference computed in fp8 where the recipe computes in bf16
(`control`), with its state left unchanged (`frozen`) or left unchanged
from the fourth step on (`frozen_late`), with half of the batch left out
(`half`), and with one leaf's gradient doubled (`grad2`). Each reading
also gives each step's loss gap and the median leaf's gaps
(`compare.details`). Prints one line a reading; `--out` writes them all as
one JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import compare, harness, inputs, reference

PLANTED = (("control", "fp8", None), ("frozen", "float32", "frozen"),
           ("frozen_late", "float32", "frozen_late"), ("half", "float32", "half"),
           ("grad2", "float32", "grad2"))


def planted(cell: harness.Cell, seed: int, device) -> dict:
    """{name: {number: value}} of the control and each fault on `seed`."""
    seeds = inputs.streams(seed)
    images = inputs.images(cell.traffic, seed, device)["train_images"]
    start = inputs.weights(cell.specs, seed, device)
    k = int(cell.traffic["check_steps"])

    def steps(cast, fault):
        return reference.run_steps(cell.cfg, start, images, k, seeds["draws"],
                                   cell.steps_per_epoch, cast=cast, fault=fault)

    ref = steps("float32", None)
    out = {}
    for name, cast, fault in PLANTED:
        got = steps(cast, fault)
        nums = compare.numbers(got, ref, start)
        out[name] = {k: v for k, (v, _) in nums.items()}
        out[name]["worst"] = {k: at for k, (_, at) in nums.items()}
        out[name]["details"] = compare.details(got, ref, start)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate reads the card; none found", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload)
    report = {"cell": cell.name, "program": [], "planted": []}
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        nums = {}
        harness.measure(cell, seed, 0.0, False, "cuda", time.perf_counter(),
                        warn=lambda msg: None, detail=nums)
        more = nums.pop("details")
        row = {"seed": seed, **{k: v for k, (v, _) in nums.items()},
               "worst": {k: at for k, (_, at) in nums.items()}, "details": more}
        report["program"].append(row)
        print(f"[calibrate] program {json.dumps(row)[:1000]} in {time.perf_counter() - t0:.1f} s",
              flush=True)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        row = {"seed": seed, **planted(cell, seed, "cuda")}
        report["planted"].append(row)
        print(f"[calibrate] planted {json.dumps(row)[:4000]}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
