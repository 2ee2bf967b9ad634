"""Device milliseconds a step of the phase `loss` (the loss (NT-Xent, BYOL's MSE), from its inputs' gather and casts):
the mean over the profiled steps of the interval from its mark kernel's
start to the next mark's (`phases.py`)."""

from .. import phases


def read(run):
    return phases.read(run, "loss")
