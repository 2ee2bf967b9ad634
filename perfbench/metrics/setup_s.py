"""Seconds from the process's start to the window's first step: imports,
the inputs made on the card, the Trainer, the checked steps and the graph's
warm-up and capture."""


def read(run):
    return run["setup_s"]
