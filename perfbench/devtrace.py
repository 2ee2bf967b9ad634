"""Reading a profiler's device timeline: the device operations (kernels,
copies and sets, not the ranges the profiler mirrors there), the union of
their intervals (the time the device was busy), their kinds by name, and
the idle gaps between them with what the host was doing meanwhile.

Events are (name, start_us, end_us) tuples; `from_profiler` makes them
from a `torch.profiler.profile`.
"""

from __future__ import annotations

# ranges the profiler mirrors on the card's timeline around the kernels of
# an optimizer step or a profiler step; not device work of their own
ANNOTATIONS = ("Optimizer.step#", "Optimizer.zero_grad#", "ProfilerStep#")

# kinds of device work, by the first pattern a kernel's name contains
KINDS = (("photometric kernel", ("photometric_kernel",)),
         ("collectives", ("nccl",)),
         ("matmul and conv", ("gemm", "xmma", "nvjet", "cutlass", "conv", "sm90_", "sm80_")),
         ("normalisation", ("layer_norm", "GammaBeta", "batch_norm", "bn_fw", "bn_bw")),
         ("copies and casts", ("copy", "Memcpy", "Memset")),
         ("optimizer", ("multi_tensor_apply", "FusedSgd", "fused_sgd")),
         ("softmax", ("softmax",)),
         ("pooling", ("pool",)))
OTHER = "elementwise and other"


def kind_of(name: str) -> str:
    for kind, patterns in KINDS:
        if any(p in name for p in patterns):
            return kind
    return OTHER


def busy_us(spans) -> float:
    """The length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def span_us(ops) -> float:
    """From the first device op's start to the last one's end."""
    return max(b for _, _, b in ops) - min(a for _, a, _ in ops) if ops else 0.0


def gaps(spans) -> list[tuple[float, float]]:
    """The idle intervals between the union's pieces, in order."""
    out, end = [], None
    for a, b in sorted(spans):
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


def from_profiler(prof) -> tuple[list, list]:
    """(device ops, host events) of a finished profiler, each a list of
    (name, start_us, end_us)."""
    import torch

    device, host = [], []
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith(ANNOTATIONS):
                device.append(span)
        else:
            host.append(span)
    return device, host


def ms_by_kind(ops, steps: int) -> dict[str, float]:
    out: dict[str, float] = {}
    for name, a, b in ops:
        out[kind_of(name)] = out.get(kind_of(name), 0.0) + (b - a) / 1e3 / steps
    return out


def top_ops(ops, n: int = 10) -> list:
    """[[name, seconds], ...] of the names that took the most device time."""
    total: dict[str, float] = {}
    for name, a, b in ops:
        total[name] = total.get(name, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def longest_gaps(ops, host, n: int = 10) -> list:
    """[[what the host was doing, seconds], ...] of the longest idle gaps:
    the innermost host event that covers the gap's middle."""
    out = []
    for a, b in sorted(gaps((s, e) for _, s, e in ops), key=lambda g: g[0] - g[1])[:n]:
        mid = (a + b) / 2
        cover = [(e - s, name) for name, s, e in host if s <= mid <= e]
        out.append([min(cover)[1] if cover else "no host event", (b - a) / 1e6])
    return out
