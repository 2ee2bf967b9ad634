"""This checkout against another checkout of the repo on one CUDA card, in
turns:

    python -m ssv_tpu_torch.tools.paired --other DIR [--pairs 3]

DIR holds another commit of the repo (for example the parent, unpacked by
`git archive`). Runs alternate between the two, so that drift of the card
and of the host falls on both alike:

- the photometric kernel, built from each checkout's csrc/photometric.cu
  and called through its C entry on one input at batch 512, 32x32: event
  medians warm in L2 and cold, and the profiler's time per launch, in the
  order this, other, other, this;
- the slice: each checkout's `chip_smoke.py` phase 3 (one epoch of SimCLR
  ResNet-18 at batch 512 through the CLI) in a process of its own,
  `--pairs` times each, the order within a pair flipped from one pair to
  the next.

Both checkouts' C entry must be `ssv_fused_photometric(images, order,
params, out, batch, hw, stream)`. Each run prints a line; the last line is
one JSON object with every run. Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from ..ops.photometric import photometric_reference
from .measure import (card_line, l2_flush, photometric_bound,
                      photometric_inputs, profiled_ms, times_ms)

THIS = Path(__file__).resolve().parents[2]
TOL = 1e-5
# chip_smoke.py's phases 0, 1 and 3, as every checkout since the port's
# first has them; the slice's numbers come back on a marked line.
SLICE = """
import json, chip_smoke as c
card = c.phase_env()
c.phase_build()
print("PAIRED " + json.dumps(c.phase_slice(card)))
"""


def _library(name: str, root: Path) -> ctypes.CDLL:
    """The photometric library built from `root`'s sources by `root`'s own
    build module, loaded as module `_paired_build_<name>`."""
    spec = importlib.util.spec_from_file_location(
        f"_paired_build_{name}", root / "ssv_tpu_torch" / "ops" / "build.py")
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    lib = build.load("photometric")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssv_fused_photometric.argtypes = [p, p, p, p, i, i, p]
    lib.ssv_fused_photometric.restype = i
    return lib


def _caller(lib, images, order, params, out):
    B, H, W, _ = images.shape
    args = (ctypes.c_void_p(images.data_ptr()), ctypes.c_void_p(order.data_ptr()),
            ctypes.c_void_p(params.data_ptr()), ctypes.c_void_p(out.data_ptr()), B, H * W,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))

    def run():
        err = lib.ssv_fused_photometric(*args)
        if err != 0:
            raise RuntimeError(f"photometric kernel launch failed: CUDA error {err}")
    return run


def kernels(roots: dict, card: str) -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    images, order, params, _ = photometric_inputs(512, 32, 32, g)
    want = photometric_reference(images, order, params)
    outs = {name: torch.empty_like(images) for name in roots}
    runs = {name: _caller(_library(name, root), images, order, params, outs[name])
            for name, root in roots.items()}
    for name, run in runs.items():
        run()
        torch.cuda.synchronize()
        err = (outs[name] - want).abs().max().item()
        if not err <= TOL:
            raise AssertionError(f"{name} kernel disagrees with the plain version: {err}")
    flush = l2_flush()
    res = {name: {"warm": [], "cold": [], "profiler": []} for name in roots}
    for name in ("this", "other", "other", "this"):
        res[name]["warm"] += times_ms(runs[name])
        res[name]["cold"] += times_ms(runs[name], before=flush)
        res[name]["profiler"].append(
            profiled_ms({name: runs[name]}, {name: "photometric_kernel<"})[name])
    bound_ms = photometric_bound(images, params)[0]
    out = {}
    for name, r in res.items():
        out[name] = {"warm_ms": statistics.median(r["warm"]),
                     "cold_ms": statistics.median(r["cold"]),
                     "profiler_ms": r["profiler"], "bound_ms": bound_ms}
        prof = ", ".join("none" if t is None else f"{t * 1e3:.3f}" for t in r["profiler"])
        print(f"[kernel] {name}: event median warm {out[name]['warm_ms']:.4f} ms, cold "
              f"{out[name]['cold_ms']:.4f} ms; profiler {prof} us per launch; bound "
              f"{bound_ms * 1e3:.3f} us | {card}", flush=True)
    return out


def slice_run(root: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", SLICE], cwd=root, env=env,
                          capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("PAIRED ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"slice run in {root} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("PAIRED "):])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path, help="another checkout of the repo")
    ap.add_argument("--pairs", default=3, type=int, help="slice runs of each checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the paired runs need a GPU")
    roots = {"this": THIS, "other": args.other.resolve()}
    card = card_line()
    print(card, flush=True)
    result = {"card": card, "kernel": kernels(roots, card), "slice": []}
    for k in range(args.pairs):
        for name in (("this", "other") if k % 2 == 0 else ("other", "this")):
            r = slice_run(roots[name])
            result["slice"].append({"pair": k, "tree": name, **r})
            print(f"[slice] pair {k} {name}: {r['img_per_s']:.1f} img/s, {r['launches']} "
                  f"photometric launches in {r['steps']} steps | {card}", flush=True)
    for name in roots:
        rates = [r["img_per_s"] for r in result["slice"] if r["tree"] == name]
        print(f"[slice] {name}: median {statistics.median(rates):.1f} img/s, "
              f"{min(rates):.1f}-{max(rates):.1f} over {len(rates)} runs", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
