"""Device milliseconds a step of DINO's student forward: the mean over the
profiled steps of the interval from the `student` mark to the `loss` mark
(the student's forward over the global and the local crops, and the
concatenation of its outputs; `student_marks.py`). None where the program
marks no `student`."""

from .. import student_marks


def read(run):
    return student_marks.read(run, "student", "loss", "dino_student_forward_ms")
