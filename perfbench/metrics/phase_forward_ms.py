"""Device milliseconds a step of the phase `forward` (the forward of the towers (BYOL: the target's and the online tower's), and the loss where the algorithm marks none):
the mean over the profiled steps of the interval from its mark kernel's
start to the next mark's (`phases.py`)."""

from .. import phases


def read(run):
    return phases.read(run, "forward")
