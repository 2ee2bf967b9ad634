"""Percent of the window's steps that were replays of the one captured
step graph (`StepGraph.replays`); 100 when no step re-captures. Graph mode
only."""


def read(run):
    if run["epoch_mode"] != "graph" or not run["steps"]:
        return None
    return 100.0 * run["replays"] / run["steps"]
