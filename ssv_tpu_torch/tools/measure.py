"""Kernel measurements on one CUDA card, shared by `chip_smoke.py` and
`ssv_tpu_torch.tools.paired`: the photometric kernel's inputs and its least
time, and device times by CUDA events and by the profiler.

Every function here needs a CUDA card; none runs on the CPU.
"""

from __future__ import annotations

import subprocess

import torch

TIMING_RUNS = 50
SPIN_CYCLES = 100_000_000  # about 50 ms of one SM's clock: longer than queueing the runs
FLUSH_BYTES = 64 << 20     # written between cold calls: more than the 50 MB L2
PROFILED_RUNS = 20
# H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM3 bytes/s, float32 FLOP/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# Float operations per pixel of each op of the photometric chain, as
# csrc/photometric.cu does them (add, multiply, divide, min/max, floor):
# brightness 3 x (mul + clip), contrast the gray sum plus 3 blends,
# saturation gray plus 3 blends, the hue round trip, the gate's gray.
PHOTOMETRIC_OPS = {"brightness": 9, "contrast": 24, "saturation": 23, "hue": 34,
                   "gate": 5}


def card_line() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def photometric_inputs(B, H, W, g):
    """Random params plus the edge cases: gate off (identity), hue shift
    +-0.5, gray gate 1, equal-channel images (delta 0) and all-zero images.
    Returns (images, order, params, n), the first n rows the identity."""
    from ..ops.photometric import sample_photometric_params

    dev = "cuda"
    images = torch.rand(B, H, W, 3, generator=g, device=dev)
    order, params = sample_photometric_params(
        B, {"brightness": 0.4, "contrast": 0.4, "saturation": 0.4, "hue": 0.1},
        0.2, 0.8, g, dev)
    n = max(B // 8, 1)
    params[0:n] = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0], device=dev)
    params[n:2 * n, 3] = 0.5
    params[2 * n:3 * n, 3] = -0.5
    params[3 * n:4 * n, 4] = 1.0
    images[4 * n:5 * n] = images[4 * n:5 * n, ..., :1].expand(-1, -1, -1, 3)
    images[5 * n:6 * n] = 0.0
    return images.contiguous(), order.contiguous(), params.contiguous(), n


def photometric_bound(images, params) -> tuple[float, str, int, float]:
    """Least time (ms) the card needs for one call on these inputs: the bytes
    (images read, out written, order and params read, each once) over the
    memory rate, or the float operations this input needs (hue skipped at a
    shift of 0, gate only where on) over the float32 rate, whichever is
    larger. Returns (ms, "bytes" or "operations", bytes, operations)."""
    B, H, W, _ = images.shape
    nbytes = 2 * images.numel() * 4 + B * 4 * 4 + B * 5 * 4
    per_image = (PHOTOMETRIC_OPS["brightness"] + PHOTOMETRIC_OPS["contrast"]
                 + PHOTOMETRIC_OPS["saturation"]
                 + PHOTOMETRIC_OPS["hue"] * (params[:, 3] != 0).double()
                 + PHOTOMETRIC_OPS["gate"] * (params[:, 4] > 0.5).double())
    ops = float(per_image.sum().item()) * H * W
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes", nbytes, ops
    return ops_ms, "operations", nbytes, ops


def times_ms(fn, runs=TIMING_RUNS, before=None):
    """Device time of each of `runs` calls, each between its own pair of
    CUDA events. A spin kernel queued first keeps the card busy while the
    host queues every call, so the events time the device and not the launch
    path. After a warm-up call the inputs stay in L2, as they are when the
    pipeline calls the op right after producing them, unless `before`, run
    outside the event pair, evicts them."""
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(runs)]
    torch.cuda._sleep(SPIN_CYCLES)
    for start, end in pairs:
        if before is not None:
            before()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in pairs]


def l2_flush():
    """A function that writes FLUSH_BYTES on the card, evicting L2."""
    buf = torch.empty(FLUSH_BYTES // 4, device="cuda")
    return lambda: buf.fill_(1.0)


def profiled_ms(fns: dict, marks: dict, runs=PROFILED_RUNS) -> dict:
    """Device time (ms) per launch of each kernel in the profiler, the
    functions called in turns `runs` times; `marks[name]` is a substring of
    that kernel's name. None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            for fn in fns.values():
                fn()
        torch.cuda.synchronize()
    found = {}
    for e in prof.key_averages():
        for name, mark in marks.items():
            if mark in e.key and e.device_time_total > 0:
                t, n = found.get(name, (0.0, 0))
                found[name] = (t + e.device_time_total, n + e.count)
    return {name: found[name][0] / found[name][1] / 1e3 if name in found else None
            for name in marks}
