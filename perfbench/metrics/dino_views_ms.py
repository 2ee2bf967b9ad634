"""Device milliseconds a step of DINO's views: the mean over the profiled
steps of the interval from the `views` mark to the `forward` mark (the
index row and gather, both base views with their photometric launches,
the four groups of bicubic crops, the unused test view; `phases.py`). It
also prints the phases' sum against the device span a step."""

from .. import phases, student_marks


def read(run):
    value = phases.read(run, "views")
    if value is not None:
        student_marks.print_sum(run)
    return value
