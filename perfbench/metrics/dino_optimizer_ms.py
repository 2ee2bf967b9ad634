"""Device milliseconds a step of DINO's optimizer: the mean over the
profiled steps of the interval from the `optimizer` mark to the `state`
mark (AdamW with the element clamp, the decay read from its table, the
schedule's advance; `phases.py`)."""

from .. import phases


def read(run):
    return phases.read(run, "optimizer")
