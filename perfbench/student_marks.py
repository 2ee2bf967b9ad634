"""The DINO step's two forwards on the profiled part's device timeline.

The port marks DINO's step with one more mark, `student`, between
`forward` and `loss` (`ssv_mark_student`): `forward` -> `student` is the
teacher's forward over the global crops, `student` -> `loss` the student's
over all crops. `phases.py` does not know the mark, so its `forward` phase
keeps both towers; this module reads the two intervals from the marks of
each profiled step (`phases.steps`). Where no step holds both marks of an
interval (a program without the `student` mark), `read` returns None.
"""

from __future__ import annotations

from . import devtrace, phases


def intervals(ops, first: str, second: str) -> list[tuple[float, float]]:
    """(start_us, end_us) from mark `first` to mark `second` in every
    profiled step that holds both."""
    return [(step[first], step[second]) for step in phases.steps(ops)
            if first in step and second in step]


def read(run, first: str, second: str, name: str):
    """The mean ms a step from mark `first` to mark `second`, with its busy
    and idle ms printed beside it; None where no step holds both."""
    prof = run.get("profile")
    if prof is None or not prof["ops"]:
        return None
    spans = intervals(prof["ops"], first, second)
    if not spans:
        return None
    ms = sum(b - a for a, b in spans) / len(spans) / 1e3
    busy = phases.busy_ms(prof["ops"], spans)
    print(f"[perfbench] {name}: {ms:.4f} ms a step over {len(spans)} steps; device busy "
          f"{busy:.4f}, idle {ms - busy:.4f}")
    return ms


def print_sum(run) -> None:
    """Prints the phases' sum a step against the profiled part's device
    span a step, where the steps are marked."""
    prof = run.get("profile")
    got = phases.phase_ms(prof["ops"]) if prof and prof["ops"] else None
    if not got:
        return
    summed = sum(got.values())
    span = devtrace.span_us(prof["ops"]) / prof["steps"] / 1e3
    print(f"[perfbench] phases: their sum {summed:.4f} ms a step, the device span a step "
          f"{span:.4f} ms ({100.0 * (summed / span - 1.0):+.3f} %); "
          + ", ".join(f"{k} {v:.4f}" for k, v in got.items()))
