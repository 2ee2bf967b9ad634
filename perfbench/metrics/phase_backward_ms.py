"""Device milliseconds a step of the phase `backward` (the backward and the gradients' reduction over the ranks):
the mean over the profiled steps of the interval from its mark kernel's
start to the next mark's (`phases.py`)."""

from .. import phases


def read(run):
    return phases.read(run, "backward")
