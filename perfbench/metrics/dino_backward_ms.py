"""Device milliseconds a step of DINO's backward: the mean over the
profiled steps of the interval from the `backward` mark to the `optimizer`
mark (the student's backward through the heads and the ViT; `phases.py`)."""

from .. import phases


def read(run):
    return phases.read(run, "backward")
