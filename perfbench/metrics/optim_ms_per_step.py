"""Device milliseconds a step of the kind optimizer (`devtrace.KINDS`, by
kernel name) in the profiled part."""

from .. import devtrace


def read(run):
    prof = run.get("profile")
    if prof is None or not prof["ops"]:
        return None
    return devtrace.ms_by_kind(prof["ops"], prof["steps"]).get("optimizer", 0.0)
