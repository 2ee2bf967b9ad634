"""Device milliseconds a step of the phase `optimizer` (the optimizer's update, the update mask and the schedule's advance):
the mean over the profiled steps of the interval from its mark kernel's
start to the next mark's (`phases.py`)."""

from .. import phases


def read(run):
    return phases.read(run, "optimizer")
