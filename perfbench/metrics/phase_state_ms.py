"""Device milliseconds a step of the phase `state` (the state after the update: the EMA, banks and the metric writes):
the mean over the profiled steps of the interval from its mark kernel's
start to the next mark's (`phases.py`)."""

from .. import phases


def read(run):
    return phases.read(run, "state")
