"""Device milliseconds a step of DINO's teacher: the mean over the profiled
steps of the interval from the `forward` mark to the `student` mark (the
teacher's no-gradient forward over the global crops; `student_marks.py`).
None where the program marks no `student`."""

from .. import student_marks


def read(run):
    return student_marks.read(run, "forward", "student", "dino_teacher_ms")
