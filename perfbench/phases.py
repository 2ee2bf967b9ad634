"""The train step's phases on the profiled part's device timeline.

The port marks each step on the card with one single-thread kernel a mark,
`ssv_mark_<mark>` (`views`, `forward`, `loss`, `backward`, `optimizer`,
`state`, `end`), replayed with the captured step. A step's marks start at
its `views`. A phase runs from the start of its mark's kernel to the start
of the next mark present in the step (an algorithm without a `loss` mark
keeps its loss in `forward`); `between` runs from a step's `end` to the next
step's `views`. Where the profiled part holds no mark (a program without
them), every function here returns None.

Events are (name, start_us, end_us) tuples, as `devtrace.from_profiler`
gives them.
"""

from __future__ import annotations

from . import devtrace

PREFIX = "ssv_mark_"
MARKS = ("views", "forward", "loss", "backward", "optimizer", "state", "end")
PHASES = MARKS[:-1] + ("between",)


def steps(ops) -> list[dict[str, float]]:
    """The profiled steps' marks, in order: {mark: its kernel's start}."""
    out = []
    for name, a, _ in sorted((op for op in ops if op[0].startswith(PREFIX)),
                             key=lambda op: op[1]):
        mark = name[len(PREFIX):].split("(")[0]
        if mark == "views" or not out:
            out.append({})
        out[-1][mark] = a
    return out


def intervals(ops) -> dict[str, list[tuple[float, float]]] | None:
    """Each phase's (start_us, end_us) interval in every step that has it."""
    marked = steps(ops)
    if not marked:
        return None
    out: dict[str, list] = {}
    for i, step in enumerate(marked):
        present = [m for m in MARKS if m in step]
        for m, nxt in zip(present, present[1:]):
            out.setdefault(m, []).append((step[m], step[nxt]))
        if "end" in step and i + 1 < len(marked) and "views" in marked[i + 1]:
            out.setdefault("between", []).append((step["end"], marked[i + 1]["views"]))
    return out


def phase_ms(ops) -> dict[str, float] | None:
    """The mean over the profiled steps of each phase present, in ms."""
    spans = intervals(ops)
    if spans is None:
        return None
    return {p: sum(b - a for a, b in spans[p]) / len(spans[p]) / 1e3
            for p in PHASES if spans.get(p)}


def busy_ms(ops, spans) -> float:
    """The mean over `spans` of the device's busy time inside each, in ms:
    the union of the device ops' intervals clipped to it."""
    total = 0.0
    for a, b in spans:
        total += devtrace.busy_us((max(s, a), min(e, b)) for _, s, e in ops if s < b and e > a)
    return total / len(spans) / 1e3


def mark_cost_ms(ops) -> list[float] | None:
    """The marks' cost in each profiled step, in ms: the mark kernels'
    device time and the idle gaps that border each (from the op before it
    to the op after it, where idle)."""
    marked = steps(ops)
    if not marked:
        return None
    order = sorted(ops, key=lambda op: op[1])
    cost, reach = [], order[0][1]       # reach: the latest end of the ops before
    for i, (name, a, b) in enumerate(order):
        if name.startswith(PREFIX):
            if name.startswith(PREFIX + "views") or not cost:
                cost.append(0.0)
            cost[-1] += b - a + max(0.0, a - reach)
            if i + 1 < len(order):
                cost[-1] += max(0.0, order[i + 1][1] - b)
        reach = max(reach, b)
    return [c / 1e3 for c in cost]


def read(run, phase: str):
    """A phase's reader: its mean ms a step over the profiled steps, with
    its busy and idle ms printed beside it; None where nothing is marked."""
    prof = run.get("profile")
    if prof is None or not prof["ops"]:
        return None
    spans = intervals(prof["ops"])
    if not spans or not spans.get(phase):
        return None
    ms = sum(b - a for a, b in spans[phase]) / len(spans[phase]) / 1e3
    busy = busy_ms(prof["ops"], spans[phase])
    print(f"[perfbench] phase_{phase}_ms: {ms:.4f} ms a step over {len(spans[phase])} steps; "
          f"device busy {busy:.4f}, idle {ms - busy:.4f}")
    return ms
