"""Device milliseconds between steps: the mean over the profiled steps of
the interval from one step's `end` mark to the next step's `views` mark
(the position's advance and the next replay's launch; `phases.py`). It
also prints the sum of the phases against the profiled part's device span a
step, and the marks' own cost a step (its median over the steps, and its
mean, which carries the profiler's start-up gap beside the first mark)."""

import statistics

from .. import devtrace, phases


def read(run):
    value = phases.read(run, "between")
    if value is None:
        return None
    prof = run["profile"]
    summed = sum(phases.phase_ms(prof["ops"]).values())
    span = devtrace.span_us(prof["ops"]) / prof["steps"] / 1e3
    cost = phases.mark_cost_ms(prof["ops"])
    median, mean = statistics.median(cost), sum(cost) / len(cost)
    print(f"[perfbench] phases: their sum {summed:.4f} ms a step, the device span a step "
          f"{span:.4f} ms ({100.0 * (summed / span - 1.0):+.3f} %); the marks' kernels and "
          f"the idle gaps beside them, ms a step: median {median:.4f} "
          f"({100.0 * median / span:.3f} %), mean {mean:.4f} ({100.0 * mean / span:.3f} %), "
          f"first step {cost[0]:.4f}")
    return value
