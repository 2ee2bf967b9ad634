"""A cell cut to a size the CPU runs in seconds, for the tests: batch 8,
80 train images; the program in float32 unless asked otherwise. The
warm-up is 9,700 steps long, ten times the full cell's (10 epochs of 97
steps), so the checked steps take a tenth of the full cell's learning
rates: at batch 8 and the full rates SimCLR's first steps are chaotic (the
reference alone, its weights moved by 1e-7 of themselves, parts from its
own loss by 5e-3 within five steps), and the port and the reference, both
in float32, would part as far."""

from perfbench import harness

TRAFFIC = {"n_train": 80, "n_test": 16, "profile_steps": 2}
SCHEDULE = {"epochs": 100000, "scheduler": {"warmup_epochs": 970}}


def cell(name: str, float32: bool = True) -> harness.Cell:
    over = {"data": {"batch_size": 8}, **SCHEDULE}
    if float32:
        over["compute_dtype"] = "float32"
    return harness.Cell(name, overrides=over, traffic=TRAFFIC)


def measure(name: str, seed: int = 2**33 + 7, traced: bool = False, float32: bool = True,
            detail: dict | None = None):
    import time

    return harness.measure(cell(name, float32), seed, 0.0, traced, "cpu", time.perf_counter(),
                           log=lambda msg: None, warn=lambda msg: None, detail=detail)
