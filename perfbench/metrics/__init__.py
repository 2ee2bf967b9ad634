"""One reader a metric, `<metric name>.py`, each with `read(run)`: the
metric's value from a finished run (`harness.measure`'s record: the
window's counts and host-clock times, the CUDA events' step intervals, the
graph's replays, and with `--trace 1` the profiled part's device ops), or
None where the run holds nothing to read it from; the harness then leaves
the metric out of the line."""
