"""The port's spans and counters, in one place.

  * `span(name, record=False)`: a host span. While a `torch.profiler` is
    active it is a `torch.profiler.record_function` range, on the
    profiler's clock, which the card's timeline shares (so a trace names an
    idle gap of the device by the span over it); with no profiler active it
    enters no range at all. With `record=True` it also appends
    `(name, parent, start_ns, end_ns)` (`time.perf_counter_ns`; `parent`
    the enclosing recorded span's name, or None) to `spans`, a ring of the
    last `RING` recorded spans, kept until `write` empties it. Only coarse
    work is recorded: the trainer's set-up, the epoch boundary, evals,
    checkpoints, the graph's warm-up steps and its capture; never a step.
  * `counters`: one dict of the process's counts, by name (`count`):
    `graph.captures`, `graph.replays`, `graph.warmup_steps`,
    `graph.drops.<reason>` (`refill`, `load`, `shape`: why the trainer
    dropped a captured step), the kernels' launches `LAUNCHES`
    (`photometric.launches`, `stem.launches`, `attention.launches`: counted
    by their wrappers as they launch), the work counts `WORK` (`vit.tokens`: the tokens, padded,
    times the batch of every `TransformerEncoder` forward; `multicrop.crops`:
    the crops `MultiCrop.crops` makes), `collectives.calls`, `.bytes` and
    `.host_s` (host seconds inside them). A graph replay adds the launches
    and work counts its capture held (`REPLAYED`).
  * The step's phase marks (`phases`, `phase`): inside `Trainer._train_step`
    each `phase(mark)` starts the phase `mark` of `MARKS` and ends the one
    before it. An algorithm marks the steps of its `marks` (`STEP_MARKS`,
    or all of `MARKS` for DINO, whose `student` mark splits the teacher's
    forward from the student's). On CUDA it launches the mark kernel
    `ssv_mark_<mark>` (`ops/phase_mark.py`), which writes the card's
    `%globaltimer` into `stamps[pos, column]`, the column the mark's place
    in the step's marks, at the step's position `pos` read on the device,
    so a captured step replays its marks with the graph; under a profiler
    the same call closes the host range of the phase before and opens
    `phase.<mark>`. A phase runs from its mark to the next mark present;
    `end`'s runs to the next step's `views` (`between`). Off CUDA the marks
    write nothing.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import time
from collections import deque

import torch

from ..ops.phase_mark import phase_mark

MARKS = ("views", "forward", "student", "loss", "backward", "optimizer", "state", "end")
# the marks of every algorithm's step but DINO's
STEP_MARKS = tuple(m for m in MARKS if m != "student")
# the counters of kernel launches (`ops/photometric.py`, `ops/stem.py`,
# `ops/attention.py`)
LAUNCHES = ("photometric.launches", "stem.launches", "attention.launches")
# the counters of work done (`models/vit.py`, `data/multicrop.py`)
WORK = ("vit.tokens", "multicrop.crops")
# what a graph replay adds again, as its capture counted it
REPLAYED = LAUNCHES + WORK
RING = 4096

counters: dict[str, int | float] = {}
spans: deque = deque(maxlen=RING)
_recorded = 0         # spans ever recorded: `since` tells an epoch's from the ring's
_open: list[str] = []  # the recorded spans open now, innermost last


def count(key: str, n: int | float = 1) -> None:
    counters[key] = counters.get(key, 0) + n


def profiling() -> bool:
    """Whether a torch profiler is recording on this thread."""
    return torch._C._autograd._profiler_enabled()


class span:
    """The context manager of the module docstring."""

    __slots__ = ("name", "record", "_range", "_t0")

    def __init__(self, name: str, record: bool = False):
        self.name, self.record, self._range = name, record, None

    def __enter__(self):
        if profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self.record:
            _open.append(self.name)
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _recorded
        if self.record:
            t1 = time.perf_counter_ns()
            _open.pop()
            spans.append((self.name, _open[-1] if _open else None, self._t0, t1))
            _recorded += 1
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


def position() -> int:
    """A token for `since`: the count of spans recorded so far."""
    return _recorded


def since(token: int) -> list[tuple]:
    """The spans recorded after `position()` returned `token`, as far as
    the ring still holds them."""
    n = min(_recorded - token, len(spans))
    return list(spans)[len(spans) - n:] if n > 0 else []


def seconds(names, recorded=None) -> dict[str, float]:
    """Seconds by name of the recorded spans named in `names`, summed over
    `recorded` (default: the whole ring)."""
    out = dict.fromkeys(names, 0.0)
    for name, _, t0, t1 in spans if recorded is None else recorded:
        if name in out:
            out[name] += (t1 - t0) / 1e9
    return out


def last_seconds(name: str) -> float | None:
    """The length of the last recorded span of `name` still in the ring."""
    for n, _, t0, t1 in reversed(spans):
        if n == name:
            return (t1 - t0) / 1e9
    return None


def write(path: str) -> None:
    """Appends the ring's spans to `path` as JSON lines, and empties it."""
    with open(path, "a") as f:
        for name, parent, t0, t1 in spans:
            f.write(json.dumps({"name": name, "parent": parent, "start_ns": t0,
                                "end_ns": t1}) + "\n")
    spans.clear()


# --------------------------------------------------------------------------
# the step's phase marks
# --------------------------------------------------------------------------

class _Step:
    __slots__ = ("stamps", "pos", "marks", "range")

    def __init__(self, stamps, pos, marks):
        self.stamps, self.pos, self.marks, self.range = stamps, pos, marks, None


_step: _Step | None = None


@contextlib.contextmanager
def phases(stamps: torch.Tensor | None, pos: torch.Tensor, marks: tuple = STEP_MARKS):
    """The block is one train step: `phase` marks it with `marks`. `stamps`
    is the epoch's (steps, len(marks)) int64 buffer on the card, or None
    (off CUDA: no device marks); `pos` the step's position, a 0-dim int64
    on the same device."""
    global _step
    _step = _Step(stamps, pos, marks)
    try:
        yield
    finally:
        step, _step = _step, None
        if step.range is not None:
            step.range.__exit__(None, None, None)


def phase(mark: str) -> None:
    """Starts phase `mark` of the step open in `phases` (the module
    docstring); outside one, does nothing."""
    step = _step
    if step is None:
        return
    if mark not in step.marks:
        raise ValueError(f"phase {mark!r} is not among the step's marks {step.marks}")
    if step.stamps is not None:
        phase_mark(MARKS.index(mark), step.marks.index(mark), step.pos, step.stamps)
    if step.range is not None:
        step.range.__exit__(None, None, None)
        step.range = None
    if mark != "end" and profiling():
        step.range = torch.profiler.record_function(f"phase.{mark}")
        step.range.__enter__()


def phase_ms(stamps: torch.Tensor, marks: tuple = STEP_MARKS) -> dict[str, float] | None:
    """The median over an epoch's steps of each phase, in ms, from the
    epoch's stamps on the host (a column a mark of `marks`): each mark
    present in every step to the next one present, and `between`, one
    step's `end` to the next step's `views`. None where no step was
    marked."""
    present = [i for i in range(len(marks)) if stamps.shape[0] and bool((stamps[:, i] > 0).all())]
    if len(present) < 2:
        return None
    t = stamps.tolist()
    out = {marks[a]: statistics.median(row[b] - row[a] for row in t) / 1e6
           for a, b in zip(present, present[1:])}
    views, end = marks.index("views"), marks.index("end")
    if views in present and end in present and len(t) > 1:
        out["between"] = statistics.median(
            nxt[views] - row[end] for row, nxt in zip(t, t[1:])) / 1e6
    return out
