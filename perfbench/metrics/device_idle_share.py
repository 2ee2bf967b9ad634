"""Percent of the profiled part's device timeline (its first device op's
start to its last one's end) in which no operation ran on the card: 1
minus the union of the device ops' intervals over that span. The span
leaves out the profiler's own start-up before the first op."""

from .. import devtrace


def read(run):
    prof = run.get("profile")
    if prof is None or not prof["ops"]:
        return None
    busy = devtrace.busy_us((a, b) for _, a, b in prof["ops"])
    return 100.0 * (1.0 - busy / devtrace.span_us(prof["ops"]))
