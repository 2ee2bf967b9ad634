"""Device milliseconds a step of the phase `views` (the step's batch: its index row, the gather and both views' augmentation, the photometric kernel included):
the mean over the profiled steps of the interval from its mark kernel's
start to the next mark's (`phases.py`)."""

from .. import phases


def read(run):
    return phases.read(run, "views")
